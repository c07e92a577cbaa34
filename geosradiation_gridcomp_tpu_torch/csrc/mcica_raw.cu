// K7: raw McICA subcolumn draws for the verification suite.
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/ops/mcica_pallas.py:
// mcica_subcols_raw, which emits the raw presence mask and the forward-
// filled condensate cdf so that the zcw polynomial fit can be A/B-tested
// against the exact table on identical draws. The TPU kernel shares its
// draw code with the production kernel (_draw_fields); this one shares
// K1's and K2's generator (mcica_gen.cuh: draws), so its realizations are
// the ones K1 and K2 turn into optics, and equal the plain twin
// (ops/mcica.py:subcolumns_raw) bit for bit.
//
// Bound on the H100: integer ALU, 4 threefry calls of 20 rounds per
// (column, layer, subcolumn), then writing the two [ncol, nlay, nsub]
// outputs (8 B per cell). Design: one block per column, one thread per
// subcolumn, both forward fills as a serial loop down the layers in
// registers; each layer's stores are coalesced across the subcolumns.

#include "mcica_gen.cuh"

namespace {

using namespace geosrad;

constexpr int BLOCK = 160;

__global__ void __launch_bounds__(BLOCK)
mcica_raw_kernel(const uint32_t* __restrict__ keys,
                 const float* __restrict__ alpha,
                 const float* __restrict__ rcorr,
                 const float* __restrict__ cldf,
                 float* __restrict__ cloudy, float* __restrict__ v3,
                 int nlay, int nsub) {
    const int col = blockIdx.x;
    const size_t row = static_cast<size_t>(col) * nlay;
    const Column c{keys + static_cast<size_t>(col) * 8, alpha + row,
                   rcorr + row, cldf + row, nullptr, nullptr, nullptr,
                   nullptr, nlay, 0, 0, 1, 0.0f};
    for (int g = threadIdx.x; g < nsub; g += BLOCK) {
        draws(c, g, true, [&](int l, bool cl, float c3) {
            const size_t i = (row + l) * nsub + g;
            cloudy[i] = cl ? 1.0f : 0.0f;
            v3[i] = c3;
        });
    }
}

}  // namespace

extern "C" int mcica_subcols_raw(const uint32_t* keys, const float* alpha,
                                 const float* rcorr, const float* cldf,
                                 float* cloudy, float* v3, int ncol,
                                 int nlay, int nsub, void* stream) {
    if (ncol <= 0 || nlay <= 0 || nsub <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    mcica_raw_kernel<<<ncol, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, alpha, rcorr, cldf, cloudy, v3, nlay, nsub);
    return static_cast<int>(cudaGetLastError());
}
