// K2: McICA stochastic cloud subcolumns + delta-scaled RRTMG-SW cloud optics.
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/ops/mcica_pallas.py:
// mcica_optics_sw_fused and computes what the CPU oracle computes
// (ops/mcica.py:generate_stochastic_clouds with the SW seed order + clear_
// counts_three_band + models/rrtmg/cldprmc_sw.py:cldprmc_sw). The generator
// is K1's (mcica_gen.cuh): the oracle's threefry stream and the exact
// (3, 1000) class table, so masks and counts equal the oracle's bit for bit;
// the per-column subkeys come from the SW seed order (3, 2, 1, 0). The
// cloud optics use the oracle's own expressions on the 8 per-band planes of
// band_optics_coeffs_sw (extinction, ssa, asymmetry and forward fraction of
// ice and liquid, expanded band -> g here), with its max(den, 1e-12) guards
// and CLDMIN floors.
//
// Bound on the H100: integer ALU for the generator (2.6e8 threefry calls at
// 8192 x 72 x 112), then writing taucmc, ssacmc, asmcmc and the cloudy mask
// (13 B per cell and g-point, 860 MB). Design: one block per column, one
// thread per g-point (112 of 128), the whole column in registers as in K1;
// the 8 band planes of a layer are read by all threads of a band from L1.
// A column with no cloud fraction anywhere skips the generator and writes
// the clear values (tau 0, ssa 1, asymmetry 0).

#include "mcica_gen.cuh"

namespace {

using namespace geosrad;

constexpr int BLOCK = 128;
constexpr float CLDMIN = 1.0e-20f;

struct CloudOptics {
    float tau, ssa, asm_;
};

// cldprmc_sw for one (cell, g-point): c points at the cell's band entry of
// the first plane; planes are `plane` floats apart in the order extcoice,
// ssacoice, gice, forwice, extcoliq, ssacoliq, gliq, forwliq.
__device__ __forceinline__ CloudOptics cloud_optics(const float* c,
                                                    size_t plane, bool cy,
                                                    float ci, float cw) {
    const bool has_ice = cy && ci > 0.0f;
    const bool has_liq = cy && cw > 0.0f;
    const float extcoice = has_ice ? c[0] : 0.0f;
    const float ssacoice = has_ice ? c[plane] : 0.0f;
    const float gice = has_ice ? c[2 * plane] : 0.0f;
    const float forwice = has_ice ? c[3 * plane] : 0.0f;
    const float extcoliq = has_liq ? c[4 * plane] : 0.0f;
    const float ssacoliq = has_liq ? c[5 * plane] : 0.0f;
    const float gliq = has_liq ? c[6 * plane] : 0.0f;
    const float forwliq = has_liq ? c[7 * plane] : 0.0f;

    const float tauliqorig = cw * extcoliq;
    const float tauiceorig = ci * extcoice;
    const float denl = 1.0f - forwliq * ssacoliq;
    const float deni = 1.0f - forwice * ssacoice;
    const float ssaliq = ssacoliq * (1.0f - forwliq) / fmaxf(denl, 1e-12f);
    const float ssaice = ssacoice * (1.0f - forwice) / fmaxf(deni, 1e-12f);
    const float tauliq = denl * tauliqorig;
    const float tauice = deni * tauiceorig;
    const float scatliq = ssaliq * tauliq;
    const float scatice = fmaxf(ssaice * tauice,
                                (has_ice || has_liq) ? CLDMIN : 0.0f);
    float tau = tauliq + tauice;
    if (cy && tau == 0.0f) tau = CLDMIN;
    const float gl_d = (gliq - forwliq) / fmaxf(1.0f - forwliq, 1e-12f);
    const float gi_d = (gice - forwice) / fmaxf(1.0f - forwice, 1e-12f);
    const float scat_tot = fmaxf(scatliq + scatice, 1e-30f);
    CloudOptics o;
    o.tau = cy ? tau : 0.0f;
    o.ssa = cy ? (scatliq + scatice) / fmaxf(tau, CLDMIN) : 1.0f;
    o.asm_ = cy ? (scatliq * gl_d + scatice * gi_d) / scat_tot : 0.0f;
    return o;
}

__global__ void __launch_bounds__(BLOCK)
mcica_sw_kernel(const uint32_t* __restrict__ keys,
                const float* __restrict__ alpha,
                const float* __restrict__ rcorr,
                const float* __restrict__ cldf,
                const float* __restrict__ ciwp,
                const float* __restrict__ clwp,
                const int* __restrict__ sigcls,
                const float* __restrict__ coeffs,
                const float* __restrict__ zcw_cols,
                float* __restrict__ taucmc,
                float* __restrict__ ssacmc,
                float* __restrict__ asmcmc,
                unsigned char* __restrict__ cldymc,
                int* __restrict__ counts,
                int ncol, int nlay, int cloud_mh, int cloud_lm, int inhm,
                float cwp_tiny) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* zcw = reinterpret_cast<float*>(dyn_smem);        // [3 * 1000]
    __shared__ int clear[4];

    const int col = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < NGPT_SW;
    const size_t row = static_cast<size_t>(col) * nlay;
    const size_t plane = static_cast<size_t>(ncol) * nlay * NBND_SW;

    if (g < 4) clear[g] = 0;
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
        const int band = band_of_sw(g);
        f = subcolumn(c, g, [&](int l, bool cy, float ci, float cw) {
            const size_t i = row + l;
            const CloudOptics o = cloud_optics(coeffs + i * NBND_SW + band,
                                               plane, cy, ci, cw);
            const size_t o_i = i * NGPT_SW + g;
            taucmc[o_i] = o.tau;
            ssacmc[o_i] = o.ssa;
            asmcmc[o_i] = o.asm_;
            cldymc[o_i] = cy ? 1 : 0;
        });
    } else if (active) {
        for (int l = 0; l < nlay; ++l) {
            const size_t o_i = (row + l) * NGPT_SW + g;
            taucmc[o_i] = 0.0f;
            ssacmc[o_i] = 1.0f;
            asmcmc[o_i] = 0.0f;
            cldymc[o_i] = 0;
        }
    }
    if (active) count_clear(clear, f);
    __syncthreads();
    if (g < 4) counts[col * 4 + g] = clear[g];
}

}  // namespace

extern "C" int mcica_optics_sw(const uint32_t* keys, const float* alpha,
                               const float* rcorr, const float* cldf,
                               const float* ciwp, const float* clwp,
                               const int* sigcls, const float* coeffs,
                               const float* zcw_cols, float* taucmc,
                               float* ssacmc, float* asmcmc,
                               unsigned char* cldymc, int* counts, int ncol,
                               int nlay, int cloud_mh, int cloud_lm, int inhm,
                               float cwp_tiny, void* stream) {
    if (ncol <= 0 || nlay <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * 3 * ZCW_N1;
    mcica_sw_kernel<<<ncol, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, coeffs, zcw_cols,
        taucmc, ssacmc, asmcmc, cldymc, counts, ncol, nlay, cloud_mh,
        cloud_lm, inhm, cwp_tiny);
    return static_cast<int>(cudaGetLastError());
}
