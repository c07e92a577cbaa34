// P1: forward fill down the layer axis.
//
// Replaces the TPU micro-kernel tools/profiling/fused_mcica_check.py:
// ffill_host, which runs the fused McICA kernel's overlap fill
// (geosradiation_gridcomp_tpu/ops/mcica_pallas.py:_ffill) alone: on
// [B, nlay, nsub] arrays, each cell takes the value of the nearest cell at
// or above it (in the layer axis) whose keep flag is nonzero; layer 0
// always keeps its own. The TPU kernel does it by log2(nlay) sublane
// rolls; here it is the serial chain the reference's overlap describes
// (cloud_subcol_gen.F90:403-429).
//
// Bound on the H100: memory, 8 B read and 4 B written per cell. Design:
// one thread per (batch, subcolumn), a serial walk down the layers with
// the running value in a register; neighbouring threads take neighbouring
// subcolumns, so every load and store of a layer is coalesced.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
ffill_kernel(const float* __restrict__ v, const float* __restrict__ keep,
             float* __restrict__ out, int nb, int nlay, int nsub) {
    const long long t = static_cast<long long>(blockIdx.x) * BLOCK
                        + threadIdx.x;
    if (t >= static_cast<long long>(nb) * nsub) return;
    const long long b = t / nsub;
    size_t i = static_cast<size_t>(b) * nlay * nsub
               + static_cast<size_t>(t - b * nsub);
    float cur = v[i];
    out[i] = cur;
    for (int l = 1; l < nlay; ++l) {
        i += nsub;
        if (keep[i] != 0.0f) cur = v[i];
        out[i] = cur;
    }
}

}  // namespace

extern "C" int ffill(const float* v, const float* keep, float* out, int nb,
                     int nlay, int nsub, void* stream) {
    if (nb <= 0 || nlay <= 0 || nsub <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n = static_cast<long long>(nb) * nsub;
    const unsigned grid = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
    ffill_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        v, keep, out, nb, nlay, nsub);
    return static_cast<int>(cudaGetLastError());
}
