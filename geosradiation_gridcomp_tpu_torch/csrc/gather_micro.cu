// P2: the table-gather micro-kernels, two formulations.
//
// Replace the TPU micro-kernels tools/profiling/gather_micro.py:
// pallas_gather (gather_rows here) and pallas_gather2 (gather_lanes here),
// which measure the primitive at the core of the taumol kernels and of
// setcoef's table interpolation: out[p, :] = tab[idx[p], :] for a small
// table (65..585 rows x 16 columns) and N = ncol x nlay points.
//
// gather_rows: out [N, ng] = tab[idx]. Bound on the H100: the 4 B written
// per output element (the table stays in L1/L2). Design: one thread per
// output element, so stores are coalesced; the index and the table are
// read through the read-only data cache (__ldg).
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

constexpr int ROWS_BLOCK = 256;
constexpr int LANES = 128;
constexpr int B2 = 64;          // index rows per output block
constexpr int SUB = 16;         // index rows per CUDA block
constexpr int LANE_BLOCK = 256;
constexpr int PER = SUB * LANES / LANE_BLOCK;

__device__ __forceinline__ int clamp_row(int r, int n) {
    return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__global__ void __launch_bounds__(ROWS_BLOCK)
gather_rows_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                   float* __restrict__ out, int n, int rows, int ng) {
    const long long t = static_cast<long long>(blockIdx.x) * ROWS_BLOCK
                        + threadIdx.x;
    if (t >= static_cast<long long>(n) * ng) return;
    const long long p = t / ng;
    const int g = static_cast<int>(t - p * ng);
    const int r = clamp_row(__ldg(idx + p), rows);
    out[t] = __ldg(tab + static_cast<size_t>(r) * ng + g);
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

extern "C" int gather_rows(const int* idx, const float* tab, float* out,
                           int n, int rows, int ng, void* stream) {
    if (n <= 0 || rows <= 0 || ng <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long total = static_cast<long long>(n) * ng;
    const unsigned grid =
        static_cast<unsigned>((total + ROWS_BLOCK - 1) / ROWS_BLOCK);
    gather_rows_kernel<<<grid, ROWS_BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        idx, tab, out, n, rows, ng);
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
