// K2: McICA stochastic cloud subcolumns + delta-scaled RRTMG-SW cloud optics.
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/ops/mcica_pallas.py:
// mcica_optics_sw_fused and computes what the CPU oracle computes
// (ops/mcica.py:generate_stochastic_clouds with the SW seed order + clear_
// counts_three_band + models/rrtmg/cldprmc_sw.py:cldprmc_sw). The generator
// is K1's (mcica_gen.cuh): each column's 4 threefry subkeys derived in the
// prologue from its layer pressures and the seed order (SW: (3, 2, 1, 0)),
// the oracle's threefry stream and the exact (3, 1000) class table, so
// masks and counts equal the oracle's bit for bit. As the TPU kernel takes
// the state seeds and reads per-band optics, this kernel takes play, the
// particle sizes rei/rel and the rrtmg_sw_cld tables of the configured
// iceflag, and evaluates band_optics_coeffs_sw itself: per (cell, band) the
// radius interpolation (ice: 1 Ebert-Curry, 2 Key, 3 Fu with the fdelta
// table; liquid: Hu & Stamnes with the low-radius ssa overshoot clamp), the
// index from floor of a factor formed with _rn intrinsics as the twin forms
// it, and the delta scaling folded into six per-band coefficients per
// phase pair (extinction x (1 - f ssa), that times the scaled ssa, and the
// scaled asymmetry (g - f) / (1 - f)), with the oracle's max(den, 1e-12)
// guards. Per (cell, g-point) what is left is four water-path products,
// the CLDMIN floors and two divisions (IEEE: __fdividef measured no
// faster here); the products are reordered against the oracle's
// (ci (deni ext) for deni (ci ext)), a few ulps.
//
// Bound on the H100: integer ALU for the generator (2 or 4 threefry draws
// per cell and g-point), then writing taucmc, ssacmc, asmcmc and the cloudy
// mask (13 B per cell and g-point). Design: two columns per block of 224
// threads (7 full warps), one thread per (column, g-point), the column in
// registers as in K1. Prologue: the block's (column, layer, band) band
// optics, spread over all its threads, into shared memory ([2][nlay][6][14]
// floats, 24 KB a column at 72 layers) beside the class table (12 KB); the
// tables are read through the read-only cache (__ldg). A column with no
// cloud fraction anywhere skips its subkeys, its prologue and the
// generator, and writes the clear values (tau 0, ssa 1, asymmetry 0).

#include "mcica_gen.cuh"

namespace {

using namespace geosrad;

constexpr int COLS = 2;                   // columns per block
constexpr int BLOCK = COLS * NGPT_SW;     // 224 threads, 7 full warps
constexpr int NCOEF = 6;                  // folded coefficients per band
constexpr float CLDMIN = 1.0e-20f;

// Row interpolation of a (n, 14) table at 1-based index and weight fint,
// as the twin's _interp_rows rounds it: lo + fint * (hi - lo).
__device__ __forceinline__ float interp(const float* tab, int index,
                                        float fint, int b) {
    const float lo = __ldg(tab + (index - 1) * NBND_SW + b);
    const float hi = __ldg(tab + index * NBND_SW + b);
    return __fadd_rn(lo, __fmul_rn(fint, __fsub_rn(hi, lo)));
}

// 1-based table row and weight of a radius factor, index clamped to
// [1, n - 1] as the twin clamps floor(factor).
__device__ __forceinline__ int row_of(float factor, int n, float* fint) {
    const float fl = fminf(fmaxf(floorf(factor), 1.0f),
                           static_cast<float>(n - 1));
    *fint = __fsub_rn(factor, fl);
    return static_cast<int>(fl);
}

// The delta scaling of one phase folded into three coefficients:
// ext (1 - f ssa); that times ssa (1 - f) / max(1 - f ssa, 1e-12); and
// (g - f) / max(1 - f, 1e-12). Per g-point tau = cwp * c[0], scattering =
// cwp * c[1], and its asymmetry weight c[2].
__device__ __forceinline__ void fold(float ext, float ssa, float g, float f,
                                     float* c) {
    const float den = __fsub_rn(1.0f, __fmul_rn(f, ssa));
    const float ssa_d = __fmul_rn(ssa, __fsub_rn(1.0f, f))
                        / fmaxf(den, 1e-12f);
    c[0] = __fmul_rn(den, ext);
    c[1] = __fmul_rn(ssa_d, c[0]);
    c[2] = __fsub_rn(g, f) / fmaxf(__fsub_rn(1.0f, f), 1e-12f);
}

// The rrtmg_sw_cld tables of one iceflag, packed: the ice tables (1: the
// six Ebert-Curry rows a..f; 2: ext, ssa, asy; 3: ext, ssa, asy, fdelta;
// each (nice, 14)), then the liquid ext, ssa, asy, each (nliq, 14).
struct Tables {
    const float* pack;
    int iceflag, nice, nliq;
};

// band_optics_coeffs_sw of band b at radii (re_i, re_l), folded: c[0..2]
// ice, c[3..5] liquid, each as fold().
__device__ __forceinline__ void band_optics(const Tables& t, float re_i,
                                            float re_l, int b, float* c) {
    const float* p = t.pack;
    const int n = t.nice * NBND_SW;
    float ext, ssa, g, f, fint;
    if (t.iceflag == 1) {
        ext = __fadd_rn(__ldg(p + b), __ldg(p + NBND_SW + b)
                                      / fmaxf(re_i, 1e-6f));
        ssa = __fsub_rn(__fsub_rn(1.0f, __ldg(p + 2 * NBND_SW + b)),
                        __fmul_rn(__ldg(p + 3 * NBND_SW + b), re_i));
        g = fminf(__fadd_rn(__ldg(p + 4 * NBND_SW + b),
                            __fmul_rn(__ldg(p + 5 * NBND_SW + b), re_i)),
                  0.999999f);
        f = __fmul_rn(g, g);
    } else {
        const int i = row_of(__fsub_rn(re_i, 2.0f) / 3.0f, t.nice, &fint);
        ext = interp(p, i, fint, b);
        ssa = interp(p + n, i, fint, b);
        g = interp(p + 2 * n, i, fint, b);
        if (t.iceflag == 3)
            f = fminf(__fadd_rn(interp(p + 3 * n, i, fint, b),
                                0.5f / fmaxf(ssa, 1e-12f)), g);
        else
            f = __fmul_rn(g, g);
    }
    fold(ext, ssa, g, f, c);

    const float* q = p + (t.iceflag == 1 ? 6 * NBND_SW
                          : (t.iceflag == 2 ? 3 : 4) * n);
    const int m = t.nliq * NBND_SW;
    const int i = row_of(__fsub_rn(re_l, 1.5f), t.nliq, &fint);
    ext = interp(q, i, fint, b);
    ssa = interp(q + m, i, fint, b);
    // the low-radius extrapolation overshoot (cldprmc_sw.F90:230-231)
    if (fint < 0.0f && ssa > 1.0f) ssa = __ldg(q + m + (i - 1) * NBND_SW + b);
    g = interp(q + 2 * m, i, fint, b);
    fold(ext, ssa, g, __fmul_rn(g, g), c + 3);
}

__global__ void __launch_bounds__(BLOCK)
mcica_sw_kernel(const float* __restrict__ play,
                const float* __restrict__ alpha,
                const float* __restrict__ rcorr,
                const float* __restrict__ cldf,
                const float* __restrict__ ciwp,
                const float* __restrict__ clwp,
                const int* __restrict__ sigcls,
                const float* __restrict__ rei,
                const float* __restrict__ rel,
                const float* __restrict__ tab,
                const float* __restrict__ zcw_cols,
                float* __restrict__ taucmc,
                float* __restrict__ ssacmc,
                float* __restrict__ asmcmc,
                unsigned char* __restrict__ cldymc,
                int* __restrict__ counts,
                int ncol, int nlay, int cloud_mh, int cloud_lm, int inhm,
                int seed_order, int iceflag, int nice, int nliq,
                float cwp_tiny) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* zcw = reinterpret_cast<float*>(dyn_smem);   // [3 * 1000]
    float* coef = zcw + 3 * ZCW_N1;                    // [COLS][nlay][6][14]
    __shared__ int clear[COLS][4];
    __shared__ int cloudy_col[COLS];
    __shared__ uint32_t keys[COLS][8];

    const int t = threadIdx.x;
    const int cb = t / NGPT_SW;                 // column within the block
    const int g = t - cb * NGPT_SW;
    const int col = blockIdx.x * COLS + cb;
    const bool live = col < ncol;
    const size_t row = static_cast<size_t>(live ? col : 0) * nlay;

    if (t < COLS * 4) clear[t / 4][t % 4] = 0;
    if (inhm != 0)
        for (int i = t; i < 3 * ZCW_N1; i += BLOCK) zcw[i] = zcw_cols[i];
    const Column c{keys[cb], alpha + row, rcorr + row, cldf + row,
                   ciwp + row, clwp + row, sigcls + row, zcw, nlay,
                   cloud_mh, cloud_lm, inhm, cwp_tiny};
    const bool cloud = live && any_cloud(c);
    if (g == 0) cloudy_col[cb] = cloud ? 1 : 0;
    if (cloud) column_subkeys(play + row, nlay, seed_order, g, keys[cb]);
    __syncthreads();

    // prologue: the folded band optics of every (column, layer, band) of
    // the block's columns with cloud
    const Tables tabs{tab, iceflag, nice, nliq};
    const int per_col = nlay * NBND_SW;
    for (int i = t; i < COLS * per_col; i += BLOCK) {
        const int k = i / per_col;
        if (!cloudy_col[k]) continue;
        const int r = i - k * per_col;
        const int l = r / NBND_SW;
        const int b = r - l * NBND_SW;
        const size_t cell = static_cast<size_t>(blockIdx.x * COLS + k) * nlay
                            + l;
        float v[NCOEF];
        band_optics(tabs, rei[cell], rel[cell], b, v);
        float* dst = coef + (k * nlay + l) * NCOEF * NBND_SW + b;
        for (int j = 0; j < NCOEF; ++j) dst[j * NBND_SW] = v[j];
    }
    __syncthreads();

    CloudFlags f;
    if (cloud) {
        const float* cc = coef + cb * nlay * NCOEF * NBND_SW + band_of_sw(g);
        f = subcolumn(c, g, [&](int l, bool cy, float ci, float cw) {
            const float* k = cc + l * NCOEF * NBND_SW;
            float tau = 0.0f, ssa = 1.0f, asm_ = 0.0f;
            if (cy) {
                const float scl = cw * k[4 * NBND_SW];
                const float sci = fmaxf(ci * k[NBND_SW], CLDMIN);
                tau = cw * k[3 * NBND_SW] + ci * k[0];
                if (tau == 0.0f) tau = CLDMIN;
                const float gl = cw > 0.0f ? k[5 * NBND_SW] : 0.0f;
                const float gi = ci > 0.0f ? k[2 * NBND_SW] : 0.0f;
                ssa = (scl + sci) / fmaxf(tau, CLDMIN);
                asm_ = (scl * gl + sci * gi) / fmaxf(scl + sci, 1e-30f);
            }
            const size_t o_i = (row + l) * NGPT_SW + g;
            taucmc[o_i] = tau;
            ssacmc[o_i] = ssa;
            asmcmc[o_i] = asm_;
            cldymc[o_i] = cy ? 1 : 0;
        });
    } else if (live) {
        for (int l = 0; l < nlay; ++l) {
            const size_t o_i = (row + l) * NGPT_SW + g;
            taucmc[o_i] = 0.0f;
            ssacmc[o_i] = 1.0f;
            asmcmc[o_i] = 0.0f;
            cldymc[o_i] = 0;
        }
    }
    if (live) count_clear(clear[cb], f);
    __syncthreads();
    if (t < COLS * 4 && blockIdx.x * COLS + t / 4 < ncol)
        counts[blockIdx.x * COLS * 4 + t] = clear[t / 4][t % 4];
}

}  // namespace

extern "C" int mcica_optics_sw(const float* play, const float* alpha,
                               const float* rcorr, const float* cldf,
                               const float* ciwp, const float* clwp,
                               const int* sigcls, const float* rei,
                               const float* rel, const float* tab,
                               const float* zcw_cols, float* taucmc,
                               float* ssacmc, float* asmcmc,
                               unsigned char* cldymc, int* counts, int ncol,
                               int nlay, int cloud_mh, int cloud_lm, int inhm,
                               int seed_order, int iceflag, int nice,
                               int nliq, float cwp_tiny, void* stream) {
    if (ncol <= 0 || nlay < 4 || iceflag < 1 || iceflag > 3 || nliq < 2
            || (iceflag != 1 && nice < 2))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float)
        * (3 * ZCW_N1 + static_cast<size_t>(COLS) * nlay * NCOEF * NBND_SW);
    if (smem > 48 * 1024) {
        const int rc = static_cast<int>(cudaFuncSetAttribute(
            mcica_sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem)));
        if (rc != 0) return rc;
    }
    mcica_sw_kernel<<<(ncol + COLS - 1) / COLS, BLOCK, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        play, alpha, rcorr, cldf, ciwp, clwp, sigcls, rei, rel, tab,
        zcw_cols, taucmc, ssacmc, asmcmc, cldymc, counts, ncol, nlay,
        cloud_mh, cloud_lm, inhm, seed_order, iceflag, nice, nliq, cwp_tiny);
    return static_cast<int>(cudaGetLastError());
}
