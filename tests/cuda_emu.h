// Host emulation of the CUDA subset that the port's kernels use, so that
// tests/test_torch_kernels_emulated.py can compile csrc/*.cu with g++ and
// run them on the CPU. Each CUDA thread is a std::thread; blocks run one
// after another; __syncthreads is a block-wide std::barrier and a warp
// shuffle goes through a per-warp exchange array and barrier. A block may
// be two-dimensional (threadIdx.x runs fastest, and warps are cut from the
// linear thread index as on the card).
//
// Conventions the kernel sources keep for this to work (the test rewrites
// the two source forms below before compiling):
//  * dynamic shared memory is declared exactly as
//    `extern __shared__ __align__(16) unsigned char dyn_smem[];`
//  * launches are written `kernel<<<grid, block, smem, stream>>>(args)`
//    (or `kernel<P><<<...>>>(args)` for one template argument);
//  * every thread of a block reaches every __syncthreads and every thread
//    of a warp reaches every shuffle;
//  * asynchronous copies into shared memory go through the pipeline
//    primitives of <cuda_pipeline_primitives.h> (the test points that
//    header here): a thread's copies are held back until it waits for
//    their group, so a kernel that reads a slot before waiting for it reads
//    stale data here too.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__ static
#define __constant__

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
struct float2 {
    float x, y;
};
struct float4 {
    float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
    return {x, y, z, w};
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return cudaSuccess; }
template <typename K>
inline int cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
alignas(16) inline unsigned char emu_dyn_smem[1 << 18];

namespace emu {
inline std::barrier<>* block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline float xchg[1024];
inline unsigned linear() { return threadIdx.x + threadIdx.y * blockDim.x; }
inline unsigned nthreads() { return blockDim.x * blockDim.y; }
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline float __shfl_down_sync(unsigned, float v, int d) {
    const int t = emu::linear(), lane = t % 32;
    auto& bar = *emu::warp_bars[t / 32];
    emu::xchg[t] = v;
    bar.arrive_and_wait();
    const float r = lane + d < 32 ? emu::xchg[t + d] : v;
    bar.arrive_and_wait();
    return r;
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
    const int t = emu::linear(), lane = t % 32;
    auto& bar = *emu::warp_bars[t / 32];
    emu::xchg[t] = v;
    bar.arrive_and_wait();
    const unsigned src = t - lane + (lane ^ m);
    const float r = src < emu::nthreads() ? emu::xchg[src] : v;
    bar.arrive_and_wait();
    return r;
}
inline int __any_sync(unsigned, int pred) {
    const int t = emu::linear(), lane = t % 32;
    auto& bar = *emu::warp_bars[t / 32];
    emu::xchg[t] = pred ? 1.0f : 0.0f;
    bar.arrive_and_wait();
    int any = 0;
    for (unsigned i = t - lane; i < t - lane + 32 && i < emu::nthreads(); ++i)
        any |= emu::xchg[i] != 0.0f;
    bar.arrive_and_wait();
    return any;
}
inline unsigned __ballot_sync(unsigned, int pred) {
    const int t = emu::linear(), lane = t % 32;
    auto& bar = *emu::warp_bars[t / 32];
    emu::xchg[t] = pred ? 1.0f : 0.0f;
    bar.arrive_and_wait();
    unsigned bits = 0;
    for (unsigned i = t - lane; i < t - lane + 32 && i < emu::nthreads(); ++i)
        if (emu::xchg[i] != 0.0f) bits |= 1u << (i - (t - lane));
    bar.arrive_and_wait();
    return bits;
}
// lane src's value; float and int (exchanged through the float array bit
// for bit)
inline float __shfl_sync(unsigned, float v, int src) {
    const int t = emu::linear(), lane = t % 32;
    auto& bar = *emu::warp_bars[t / 32];
    emu::xchg[t] = v;
    bar.arrive_and_wait();
    const float r = emu::xchg[t - lane + (src & 31)];
    bar.arrive_and_wait();
    return r;
}
inline int __shfl_sync(unsigned m, int v, int src) {
    float f, r;
    std::memcpy(&f, &v, 4);
    r = __shfl_sync(m, f, src);
    int out;
    std::memcpy(&out, &r, 4);
    return out;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
namespace emu {
struct Copy {
    void* dst;
    const void* src;
    size_t n;
};
inline thread_local std::vector<Copy> pending;             // not committed
inline thread_local std::vector<std::vector<Copy>> groups;  // oldest first
}  // namespace emu
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
    emu::pending.push_back({dst, src, n});
}
inline void __pipeline_commit() {
    emu::groups.push_back(std::move(emu::pending));
    emu::pending.clear();
}
// complete every committed group but the newest `prior`
inline void __pipeline_wait_prior(size_t prior) {
    while (emu::groups.size() > prior) {
        for (const auto& c : emu::groups.front())
            std::memcpy(c.dst, c.src, c.n);
        emu::groups.erase(emu::groups.begin());
    }
}
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
    const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
    return static_cast<uint32_t>((v << (s & 31)) >> 32);
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
template <typename T>
inline T __ldg(const T* p) { return *p; }
template <typename T>
inline void __stcs(T* p, T v) { *p = v; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdividef(float a, float b) { return a / b; }
// truncation toward zero; the kernels convert only values in [0, 2^32)
inline uint32_t __float2uint_rz(float x) { return static_cast<uint32_t>(x); }

template <typename K>
struct EmuLaunch {
    K kernel;
    dim3 grid, block;
    template <typename... A>
    void operator()(A... args) {
        gridDim = grid;
        blockDim = block;
        const unsigned nt = block.x * block.y;
        for (unsigned by = 0; by < grid.y; ++by)
            for (unsigned bx = 0; bx < grid.x; ++bx) {
                std::barrier<> bar(nt);
                emu::block_bar = &bar;
                emu::warp_bars.clear();
                for (unsigned w = 0; w * 32 < nt; ++w)
                    emu::warp_bars.emplace_back(
                        new std::barrier<>(std::min(32u, nt - 32 * w)));
                std::vector<std::thread> threads;
                for (unsigned t = 0; t < nt; ++t)
                    threads.emplace_back([&, t] {
                        threadIdx = dim3(t % block.x, t / block.x);
                        blockIdx = dim3(bx, by);
                        kernel(args...);
                    });
                for (auto& th : threads) th.join();
            }
    }
};

template <typename K>
EmuLaunch<K> emu_launch(K kernel, dim3 grid, dim3 block, size_t,
                        cudaStream_t = nullptr) {
    return {kernel, grid, block};
}
