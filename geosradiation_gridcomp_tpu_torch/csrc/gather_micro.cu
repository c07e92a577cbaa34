// P2: the table-gather micro-kernels, two formulations.
//
// Replace the TPU micro-kernels tools/profiling/gather_micro.py:
// pallas_gather (gather_rows here) and pallas_gather2 (gather_lanes here),
// which measure the primitive at the core of the taumol kernels and of
// setcoef's table interpolation: out[p, :] = tab[idx[p], :] for a small
// table (65..585 rows x 16 columns) and N = ncol x nlay points.
//
// gather_rows: out [N, ng] = tab[clamp(idx)], any N, rows and ng. Bound on
// the H100: the bytes, 4 B written per output element plus the 4 B index
// of each point (the table, read from L1, is counted once): at the tool's
// 8192 x 72 points x 16 columns, 37.7 MB + 2.4 MB over 3.35 TB/s, 0.0120
// ms. The first kernel (one thread per output element, a 64-bit division
// each, 4-byte stores) was issue-bound at 0.035 ms. Design:
//  * VEC floats a thread (float4 where ng % 4 == 0 and both pointers are
//    16-byte aligned, else float2 or float): a warp of 8 points x 4
//    float4 writes 512 contiguous bytes with 16-byte stores.
//  * A block is (ng / VEC) x (256 / (ng / VEC)) threads, so a thread's
//    (point, vector) comes from threadIdx with no division; each thread
//    takes ITEMS points a block height apart and issues their index
//    loads, then their table loads, then their stores, so that several
//    loads are in flight. Index arithmetic is 32-bit; only addresses
//    widen.
//  * The table stays where it is and is read through the read-only path
//    (__ldg): 37 KB sits in each SM's L1 after its first blocks.
//  * Streaming stores (__stcs, evict-first): the output is written once
//    and not read back here, so it need not stay in L2.
// On an H100 80GB HBM3 at 700 W this kernel takes 0.013 ms of device time
// at the tool's shape, 91 % of the bound (PERF.md, P2). Plain stores
// (0.015 ms), 1 or 8 points a thread, a TMA bulk store of a staged
// output tile (0.016 ms) and the table staged in shared memory by a
// persistent grid (0.019 ms) were each slower there.
//
// gather_lanes: the transposed-table contract of pallas_gather2. idx is
// [N / 128, 128], cut into blocks of 64 rows; for block k, output row
// (k * ng + g) * 64 + r, lane l holds tabT[g, idx[k * 64 + r, l]]. Bound:
// the same stores. Design: each CUDA block copies tabT ([ng, width],
// 16 x 640 x 4 B = 40 KB in the tool) into shared memory, keeps 8 indices
// per thread in registers and writes the ng output rows of its 16 index
// rows with neighbouring threads on neighbouring lanes.
//
// Indices are clamped to the table, so no index can read outside it.

#include "common.cuh"

namespace {

constexpr int ROWS_THREADS = 256;
constexpr int ROWS_ITEMS = 4;   // points per thread, a block height apart
constexpr int LANES = 128;
constexpr int B2 = 64;          // index rows per output block
constexpr int SUB = 16;         // index rows per CUDA block
constexpr int LANE_BLOCK = 256;
constexpr int PER = SUB * LANES / LANE_BLOCK;

__device__ __forceinline__ int clamp_row(int r, int n) {
    return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<1> { using T = float; };

// Widest vector of floats that divides ng and that both pointers allow.
int rows_vec(const void* tab, const void* out, int ng) {
    const auto a = reinterpret_cast<uintptr_t>(tab)
                   | reinterpret_cast<uintptr_t>(out);
    for (int v = 4; v > 1; v /= 2)
        if (ng % v == 0 && a % (sizeof(float) * v) == 0) return v;
    return 1;
}

// Block (bx, by): bx threads over a row's ngv vectors (looping where ngv
// exceeds 256), by points; blockIdx.x covers by * ROWS_ITEMS points.
template <int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
gather_rows_kernel(const int* __restrict__ idx,
                   const typename Vec<VEC>::T* __restrict__ tab,
                   typename Vec<VEC>::T* __restrict__ out, int n, int rows,
                   int ngv) {
    using V = typename Vec<VEC>::T;
    const int by = blockDim.y;
    const int p0 = blockIdx.x * by * ROWS_ITEMS + threadIdx.y;
    int r[ROWS_ITEMS];
#pragma unroll
    for (int i = 0; i < ROWS_ITEMS; ++i) {
        const int p = p0 + i * by;
        r[i] = p < n ? clamp_row(__ldg(idx + p), rows) : 0;
    }
    for (int q = threadIdx.x; q < ngv; q += blockDim.x) {
        V v[ROWS_ITEMS];
#pragma unroll
        for (int i = 0; i < ROWS_ITEMS; ++i)
            v[i] = __ldg(tab + static_cast<size_t>(r[i]) * ngv + q);
#pragma unroll
        for (int i = 0; i < ROWS_ITEMS; ++i) {
            const int p = p0 + i * by;
            if (p < n) __stcs(out + static_cast<size_t>(p) * ngv + q, v[i]);
        }
    }
}

template <int VEC>
void launch_rows(const int* idx, const float* tab, float* out, int n,
                 int rows, int ng, cudaStream_t stream) {
    using V = typename Vec<VEC>::T;
    const int ngv = ng / VEC;
    const int bx = ngv < ROWS_THREADS ? ngv : ROWS_THREADS;
    const int by = ROWS_THREADS / bx;
    const int per_block = by * ROWS_ITEMS;
    gather_rows_kernel<VEC><<<(n + per_block - 1) / per_block,
                              dim3(bx, by), 0, stream>>>(
        idx, reinterpret_cast<const V*>(tab), reinterpret_cast<V*>(out), n,
        rows, ngv);
}

__global__ void __launch_bounds__(LANE_BLOCK)
gather_lanes_kernel(const int* __restrict__ idx,
                    const float* __restrict__ tabT, float* __restrict__ out,
                    int width, int ng) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* t = reinterpret_cast<float*>(dyn_smem);   // [ng][width]
    for (int i = threadIdx.x; i < ng * width; i += LANE_BLOCK) t[i] = tabT[i];
    const int k = blockIdx.x / (B2 / SUB);
    const int r0 = (blockIdx.x % (B2 / SUB)) * SUB;
    int id[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        const int e = j * LANE_BLOCK + threadIdx.x;
        const size_t src = (static_cast<size_t>(k) * B2 + r0 + e / LANES)
                           * LANES + e % LANES;
        id[j] = clamp_row(idx[src], width);
    }
    __syncthreads();
    for (int g = 0; g < ng; ++g) {
        const size_t base = (static_cast<size_t>(k) * ng + g) * B2 + r0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int e = j * LANE_BLOCK + threadIdx.x;
            out[(base + e / LANES) * LANES + e % LANES] = t[g * width + id[j]];
        }
    }
}

}  // namespace

// The vector width gather_rows takes for these pointers and ng: 4, 2 or 1
// (the template instance that runs).
extern "C" int gather_rows_vec(const void* tab, const void* out, int ng) {
    return rows_vec(tab, out, ng);
}

extern "C" int gather_rows(const int* idx, const float* tab, float* out,
                           int n, int rows, int ng, void* stream) {
    if (n <= 0 || rows <= 0 || ng <= 0
        || n > 0x7fffffff - ROWS_THREADS * ROWS_ITEMS)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (rows_vec(tab, out, ng)) {
        case 4: launch_rows<4>(idx, tab, out, n, rows, ng, st); break;
        case 2: launch_rows<2>(idx, tab, out, n, rows, ng, st); break;
        default: launch_rows<1>(idx, tab, out, n, rows, ng, st);
    }
    return static_cast<int>(cudaGetLastError());
}

// nrows: rows of the [nrows, 128] index array, a multiple of 64.
extern "C" int gather_lanes(const int* idx, const float* tabT, float* out,
                            int nrows, int width, int ng, void* stream) {
    const size_t smem = sizeof(float) * static_cast<size_t>(ng) * width;
    if (nrows <= 0 || nrows % B2 != 0 || width <= 0 || ng <= 0
        || smem > 48 * 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    gather_lanes_kernel<<<(nrows / B2) * (B2 / SUB), LANE_BLOCK, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        idx, tabT, out, width, ng);
    return static_cast<int>(cudaGetLastError());
}
