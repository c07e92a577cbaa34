// K1: McICA stochastic cloud subcolumns + RRTMG-LW cloud optics.
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/ops/mcica_pallas.py:
// mcica_optics_lw_fused and computes what the CPU oracle computes
// (ops/mcica.py:generate_stochastic_clouds + clear_counts_three_band +
// models/rrtmg/cldprmc_lw.py:cldprmc_lw). Where the TPU kernel used the
// chip's hardware PRNG and a polynomial fit of the condensate table, this
// kernel draws the oracle's own threefry-2x32 stream and reads the exact
// (3, 1000) xcw class table (mcica_gen.cuh, shared with K2), so its masks
// and counts equal the oracle's bit for bit.
//
// Bound on the H100: integer ALU, 4 threefry calls of 20 rounds per
// (column, layer, g-point) (3.3e8 calls at 8192 x 72 x 140), then writing
// taucmc (330 MB). Design: one block per column, one thread per g-point;
// each thread generates its uniforms on the fly and runs both overlap
// forward fills as a serial loop down the layers in registers, so the
// random fields never touch memory. The class table sits in shared memory.
// A column with no cloud fraction anywhere skips the generator and writes
// zeros. The cloudy mask (OR over g) and the clear counts are shared-memory
// reductions.

#include "mcica_gen.cuh"

namespace {

using namespace geosrad;

constexpr int BLOCK = 160;

__global__ void __launch_bounds__(BLOCK)
mcica_lw_kernel(const uint32_t* __restrict__ keys,
                const float* __restrict__ alpha,
                const float* __restrict__ rcorr,
                const float* __restrict__ cldf,
                const float* __restrict__ ciwp,
                const float* __restrict__ clwp,
                const int* __restrict__ sigcls,
                const float* __restrict__ absice,
                const float* __restrict__ absliq,
                const float* __restrict__ zcw_cols,
                float* __restrict__ taucmc,
                unsigned char* __restrict__ cloudy,
                int* __restrict__ counts,
                int nlay, int cloud_mh, int cloud_lm, int inhm,
                float cwp_tiny) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* zcw = reinterpret_cast<float*>(dyn_smem);        // [3 * 1000]
    int* flag = reinterpret_cast<int*>(zcw + 3 * ZCW_N1);   // [nlay]
    __shared__ int clear[4];

    const int col = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < NGPT;
    const size_t row = static_cast<size_t>(col) * nlay;

    if (g < 4) clear[g] = 0;
    for (int l = g; l < nlay; l += BLOCK) flag[l] = 0;
    if (inhm != 0)
        for (int i = g; i < 3 * ZCW_N1; i += BLOCK) zcw[i] = zcw_cols[i];
    const Column c{keys + static_cast<size_t>(col) * 8, alpha + row,
                   rcorr + row, cldf + row, ciwp + row, clwp + row,
                   sigcls + row, zcw, nlay, cloud_mh, cloud_lm, inhm,
                   cwp_tiny};
    const bool cloud = any_cloud(c);
    __syncthreads();

    CloudFlags f;
    if (active && cloud) {
        const int band = band_of(g);
        f = subcolumn(c, g, [&](int l, bool cy, float ci, float cw) {
            const size_t i = row + l;
            const float ti = (cy && ci > 0.0f)
                ? __fmul_rn(ci, absice[i * NBND + band]) : 0.0f;
            const float tl = (cy && cw > 0.0f)
                ? __fmul_rn(cw, absliq[i * NBND + band]) : 0.0f;
            const float tau = __fadd_rn(ti, tl);
            taucmc[i * NGPT + g] = tau;
            if (tau > 0.0f) atomicOr(&flag[l], 1);
        });
    } else if (active) {
        for (int l = 0; l < nlay; ++l) taucmc[(row + l) * NGPT + g] = 0.0f;
    }
    if (active) count_clear(clear, f);
    __syncthreads();
    for (int l = g; l < nlay; l += BLOCK) cloudy[row + l] = flag[l] ? 1 : 0;
    if (g < 4) counts[col * 4 + g] = clear[g];
}

}  // namespace

extern "C" int mcica_optics_lw(const uint32_t* keys, const float* alpha,
                               const float* rcorr, const float* cldf,
                               const float* ciwp, const float* clwp,
                               const int* sigcls, const float* absice,
                               const float* absliq, const float* zcw_cols,
                               float* taucmc, unsigned char* cloudy,
                               int* counts, int ncol, int nlay, int cloud_mh,
                               int cloud_lm, int inhm, float cwp_tiny,
                               void* stream) {
    if (ncol <= 0 || nlay <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * 3 * ZCW_N1 + sizeof(int) * nlay;
    mcica_lw_kernel<<<ncol, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice, absliq,
        zcw_cols, taucmc, cloudy, counts, nlay, cloud_mh, cloud_lm, inhm,
        cwp_tiny);
    return static_cast<int>(cudaGetLastError());
}
