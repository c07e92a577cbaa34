// K6: RRTMG-SW two-stream solver with McICA clouds (spcvmc).
//
// Replaces the TPU kernels of geosradiation_gridcomp_tpu/models/rrtmg/
// spcvmc_pallas.py:spcvmc_fast (an up-pass pallas_call and a down-pass
// pallas_call) and computes what the CPU oracle models/rrtmg/spcvmc.py:
// spcvmc_sw computes: per g-point the clear-sky delta-scaled optics with the
// optional aerosol, the all-sky combination with the McICA cloud optics,
// PIFM reflectance/transmittance (reftra_sw: conservative branch decided
// from 1 - w computed from optical depths, the factored resonance-safe
// non-conservative branch with the |u| <= 0.01 psi Taylor crossover), the
// direct-beam transmittances, the surface->TOA and TOA->surface adding
// sweeps (vrtqdr_sw), then the level fluxes reduced over g into broadband,
// UV and NIR profiles and the surface band quantities. Columns at or past
// ncld run the clear-sky stream only and alias it as all-sky, as the
// oracle's ncld split does.
//
// Bound on the H100: about 8 expf per (cell, g-point, stream) per sweep and
// reading the optics (~25 B per cell and g-point, read in both sweeps; 1.7
// GB at 8192 x 72 x 112). Design: one block per column, one thread per
// g-point (112 of 128). The up sweep writes each level's composite
// reflectances (4 floats per g) to a global scratch; the down sweep
// recomputes each layer's R/T (cheaper than storing 5 fields per stream)
// and combines them with the scratch into fd/fu level by level. Each
// level's sums over g are warp sums in a fixed order, combined across the 4
// warps after the sweep, so the result is deterministic. expf, never
// __expf, and exp(x) rather than 1/exp(-x), as the oracle; the products in
// 1 - w and in the conservative predicate use __fmul_rn/__fadd_rn so no FMA
// contraction moves a cell across the branch.

#include "common.cuh"

namespace {

using namespace geosrad;

constexpr int BLOCK = 128;
constexpr int NWARP = BLOCK / 32;
constexpr int NLEVF = 14;    // level fields, LEVEL_KEYS order
constexpr float WCRIT_RESID = static_cast<float>(1.0 - 0.9999995);

struct Optics {
    float tau, w, g, womz;
};

struct Layer {
    float ref, tra, refd, trad, dbt;
};

// PIFM reflectance/transmittance of a homogeneous layer (reftra_sw,
// kmodts=2) and its direct-beam transmittance.
__device__ Layer reftra(const Optics& o, float mu0) {
    const float tau = o.tau, w = o.w, g = o.g;
    const float zg3 = 3.0f * g;
    const float gamma1 = (8.0f - w * (5.0f + zg3)) * 0.25f;
    const float gamma2 = 3.0f * (w * (1.0f - g)) * 0.25f;
    const float gamma3 = (2.0f - zg3 * mu0) * 0.25f;
    const float gamma4 = 1.0f - gamma3;

    const float qr = g / (1.0f - g);
    const float q = __fmul_rn(qr, qr);
    float den = __fsub_rn(1.0f, __fmul_rn(o.womz, q));
    if (fabsf(den) < 1e-12f) den = den < 0.0f ? -1e-12f : 1e-12f;
    const bool conservative =
        __fmul_rn(o.womz, __fsub_rn(1.0f, q)) / den <= WCRIT_RESID;

    Layer r;
    r.dbt = expf(-fminf(tau / mu0, 500.0f));
    if (conservative) {
        const float za1c = gamma1 * mu0 - gamma3;
        const float zgt = gamma1 * tau;
        const float ze2c = r.dbt;
        if (ze2c == 1.0f) {
            r.ref = 0.0f;
            r.tra = 1.0f;
            r.refd = 0.0f;
            r.trad = 1.0f;
        } else {
            r.ref = (zgt - za1c * (1.0f - ze2c)) / (1.0f + zgt);
            r.tra = 1.0f - r.ref;
            r.refd = zgt / (1.0f + zgt);
            r.trad = 1.0f - r.refd;
        }
        return r;
    }
    const float za1 = gamma1 * gamma4 + gamma2 * gamma3;
    const float za2 = gamma1 * gamma3 + gamma2 * gamma4;
    const float zrk = sqrtf(fmaxf(gamma1 * gamma1 - gamma2 * gamma2, 1e-12f));
    const float zrp = zrk * mu0;
    const float opp = 1.0f + zrp;
    const float s = 1.0f - zrp;
    const float zrkg = zrk + gamma1;
    const float g3k = zrk * gamma3;
    const float g4k = zrk * gamma4;
    const float zbeta = (gamma1 - zrk) / zrkg;

    const float ze1 = fminf(zrk * tau, 5.0f);
    const float ze2 = fminf(tau / mu0, 5.0f);
    const float zem1 = expf(-ze1);
    const float zep1 = expf(ze1);
    const float zem2 = expf(-ze2);
    const float zep2 = expf(ze2);

    const float u = ze2 - ze1;
    const float rr = fabsf(s) >= 1e-6f ? u / s : (u == 0.0f ? 0.0f : ze2);
    float psi_p, psi_m;
    if (fabsf(u) <= 0.01f) {
        psi_p = 1.0f + u * (0.5f + u * (1.0f / 6.0f));
        psi_m = 1.0f - u * (0.5f - u * (1.0f / 6.0f));
    } else {
        psi_p = (expf(u) - 1.0f) / u;
        psi_m = -(expf(-u) - 1.0f) / u;
    }
    const float zden = opp * (zrkg * zep1 + (zrk - gamma1) * zem1);
    r.ref = w * ((za2 + g3k) * (zep1 - zem2)
                 + (g3k - za2) * opp * zem2 * rr * psi_p) / zden;
    r.tra = zem2 * (1.0f - w * ((za1 - g4k) * (zep2 - zem1)
                                - (za1 + g4k) * opp * zep2 * rr * psi_m)
                               / zden);
    const float zemm = zem1 * zem1;
    const float zdend = 1.0f / ((1.0f - zbeta * zemm) * zrkg);
    r.refd = gamma2 * (1.0f - zemm) * zdend;
    r.trad = 2.0f * zrk * zem1 * zdend;
    return r;
}

// Per-(column, g-point) inputs of the solver.
struct Point {
    const float* taug;      // [nlay][112] rows of this column
    const float* taur;
    const float* taucmc;
    const float* ssacmc;
    const float* asmcmc;
    const unsigned char* cldymc;
    const float* taua;      // [nlay][14] rows, or null
    const float* ssaa;
    const float* asya;
    int g, band;

    // clear-sky delta-scaled optics of layer l (spcvmc.F90:340-356)
    __device__ Optics clear(int l) const {
        const size_t i = static_cast<size_t>(l) * NGPT_SW + g;
        const float tg = taug[i], tr = taur[i];
        float ta = 0.0f, sa = 0.0f, ya = 0.0f;
        if (taua != nullptr) {
            const size_t j = static_cast<size_t>(l) * NBND_SW + band;
            ta = taua[j];
            sa = ssaa[j];
            ya = asya[j];
        }
        const float ztauo = __fadd_rn(__fadd_rn(tr, tg), ta);
        float zomco = __fadd_rn(tr, __fmul_rn(ta, sa));
        const float zgco = __fmul_rn(__fmul_rn(ya, sa), ta)
                         / fmaxf(zomco, 1e-30f);
        zomco = zomco / ztauo;
        const float zf = __fmul_rn(zgco, zgco);
        const float zwf = __fmul_rn(zomco, zf);
        Optics o;
        o.tau = __fmul_rn(__fsub_rn(1.0f, zwf), ztauo);
        o.w = __fsub_rn(zomco, zwf) / __fsub_rn(1.0f, zwf);
        o.g = __fsub_rn(zgco, zf) / __fsub_rn(1.0f, zf);
        // 1 - w at full relative precision: absorption / total
        o.womz = __fadd_rn(tg, __fmul_rn(ta, __fsub_rn(1.0f, sa))) / ztauo
               / __fsub_rn(1.0f, zwf);
        return o;
    }

    // the clear optics c with the McICA cloud optics added where cloudy
    __device__ Optics allsky(int l, const Optics& c) const {
        const size_t i = static_cast<size_t>(l) * NGPT_SW + g;
        if (!cldymc[i]) return c;
        const float tc = taucmc[i], sc = ssacmc[i], ac = asmcmc[i];
        const float tcs = __fmul_rn(tc, sc);
        const float tg = __fadd_rn(__fmul_rn(__fmul_rn(c.tau, c.w), c.g),
                                   __fmul_rn(tcs, ac));
        const float to = __fadd_rn(__fmul_rn(c.tau, c.w), tcs);
        const float tt = __fadd_rn(c.tau, tc);
        Optics o;
        o.tau = tt;
        o.w = to / tt;
        o.g = tg / fmaxf(to, 1e-30f);
        o.womz = __fadd_rn(__fmul_rn(c.tau, c.womz),
                           __fmul_rn(tc, __fsub_rn(1.0f, sc))) / tt;
        return o;
    }
};

// Composite reflectances seen from a level, adding one layer below
// (vrtqdr_sw's surface->TOA recursion).
__device__ __forceinline__ void add_below(const Layer& y, float& rup,
                                          float& rupd) {
    const float zrefl = 1.0f / (1.0f - rupd * y.refd);
    const float rup_n = y.ref + y.trad * ((y.tra - y.dbt) * rupd
                                          + y.dbt * rup) * zrefl;
    rupd = y.refd + y.trad * y.trad * rupd * zrefl;
    rup = rup_n;
}

// Transmittance and diffuse reflectance from above, adding one layer
// (vrtqdr_sw's TOA->surface recursion); tdb = direct transmittance above.
__device__ __forceinline__ void add_above(const Layer& y, float tdb,
                                          float& ztdn, float& rdnd) {
    const float zrefl = 1.0f / (1.0f - y.refd * rdnd);
    const float ztdn_n = tdb * y.tra + y.trad * ((ztdn - tdb)
                                                 + tdb * y.ref * rdnd)
                                       * zrefl;
    rdnd = y.refd + y.trad * y.trad * rdnd * zrefl;
    ztdn = ztdn_n;
}

struct Fluxes {
    float fd, fu;
};

__device__ __forceinline__ Fluxes level_fluxes(float tdbt, float ztdn,
                                               float rdnd, float rup,
                                               float rupd) {
    const float zrefl = 1.0f / (1.0f - rdnd * rupd);
    Fluxes f;
    f.fu = (tdbt * rup + (ztdn - tdbt) * rupd) * zrefl;
    f.fd = tdbt + (ztdn - tdbt + tdbt * rup * rdnd) * zrefl;
    return f;
}

__global__ void __launch_bounds__(BLOCK)
spcvmc_kernel(const float* __restrict__ taug,
              const float* __restrict__ taur,
              const float* __restrict__ taucmc,
              const float* __restrict__ ssacmc,
              const float* __restrict__ asmcmc,
              const unsigned char* __restrict__ cldymc,
              const float* __restrict__ taua,
              const float* __restrict__ ssaa,
              const float* __restrict__ asya,
              const float* __restrict__ mu0c,
              const float* __restrict__ albdir,
              const float* __restrict__ albdif,
              const float* __restrict__ zincflx,
              const float* __restrict__ weights,
              float* __restrict__ scratch,
              float* __restrict__ lev_out,
              float* __restrict__ sfc_out,
              float* __restrict__ band_out,
              int ncol, int nlay, int ncld) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* part = reinterpret_cast<float*>(dyn_smem);  // [NLEVF][NWARP][nlev]
    __shared__ float sfc[3][NGPT_SW];                  // dir, tot, up

    const int col = blockIdx.x;
    const int gt = threadIdx.x;
    const int warp = gt / 32;
    const int lane = gt % 32;
    const int nlev = nlay + 1;
    const bool active = gt < NGPT_SW;
    const int g = active ? gt : 0;
    const int band = band_of_sw(g);
    const bool allsky = col < ncld;
    const float mu0 = mu0c[col];
    // weights: [3][112] incident flux masks (all, UV, NIR) are zincflx
    // times weights[0..1]; the surface selections follow in rows 2..4
    const float z = active ? zincflx[static_cast<size_t>(col) * NGPT_SW + g]
                           : 0.0f;
    const float z_uv = z * weights[g];
    const float z_nir = z * weights[NGPT_SW + g];
    const float adir = albdir[col * NBND_SW + band];
    const float adif = albdif[col * NBND_SW + band];

    const size_t cg = static_cast<size_t>(col) * nlay * NGPT_SW;
    const size_t ca = static_cast<size_t>(col) * nlay * NBND_SW;
    const bool aero = taua != nullptr;
    const Point p{taug + cg, taur + cg, taucmc + cg, ssacmc + cg,
                  asmcmc + cg, cldymc + cg, aero ? taua + ca : nullptr,
                  aero ? ssaa + ca : nullptr, aero ? asya + ca : nullptr, g,
                  band};
    float* scr = scratch + static_cast<size_t>(col) * nlay * 4 * NGPT_SW + g;

    // ---- up sweep (surface -> TOA): composite below each level ----
    float rup_c = adir, rupd_c = adif, rup_a = adir, rupd_a = adif;
    if (active) {
        for (int l = nlay - 1; l >= 0; --l) {
            const Optics oc = p.clear(l);
            add_below(reftra(oc, mu0), rup_c, rupd_c);
            if (allsky) add_below(reftra(p.allsky(l, oc), mu0), rup_a, rupd_a);
            float* s = scr + static_cast<size_t>(l) * 4 * NGPT_SW;
            s[0] = rup_c;
            s[NGPT_SW] = rupd_c;
            s[2 * NGPT_SW] = rup_a;
            s[3 * NGPT_SW] = rupd_a;
        }
    }

    // level l: fd/fu of both streams from the composites above and below,
    // reduced over g into the 14 level fields
    auto put = [&](int lev, float tdbt_c, float tdbt_a, const Fluxes& c,
                   const Fluxes& a) {
        const float v[NLEVF] = {
            a.fu * z, a.fd * z, c.fu * z, c.fd * z, tdbt_a * z, tdbt_c * z,
            a.fd * z_uv, c.fd * z_uv, tdbt_a * z_uv, tdbt_c * z_uv,
            a.fd * z_nir, c.fd * z_nir, tdbt_a * z_nir, tdbt_c * z_nir};
        for (int f = 0; f < NLEVF; ++f) {
            const float s = warp_sum(v[f]);
            if (lane == 0) part[(f * NWARP + warp) * nlev + lev] = s;
        }
    };

    // ---- down sweep (TOA -> surface) ----
    float ztdn_c = 1.0f, rdnd_c = 0.0f, tdbt_c = 1.0f;
    float ztdn_a = 1.0f, rdnd_a = 0.0f, tdbt_a = 1.0f;
    for (int l = 0; l < nlay; ++l) {
        const float* s = scr + static_cast<size_t>(l) * 4 * NGPT_SW;
        Fluxes fc{0.0f, 0.0f}, fa{0.0f, 0.0f};
        if (active) {
            fc = level_fluxes(tdbt_c, ztdn_c, rdnd_c, s[0], s[NGPT_SW]);
            fa = allsky ? level_fluxes(tdbt_a, ztdn_a, rdnd_a,
                                       s[2 * NGPT_SW], s[3 * NGPT_SW])
                        : fc;
        }
        put(l, tdbt_c, allsky ? tdbt_a : tdbt_c, fc, fa);
        if (active) {
            const Optics oc = p.clear(l);
            const Layer yc = reftra(oc, mu0);
            add_above(yc, tdbt_c, ztdn_c, rdnd_c);
            tdbt_c = tdbt_c * yc.dbt;
            if (allsky) {
                const Layer ya = reftra(p.allsky(l, oc), mu0);
                add_above(ya, tdbt_a, ztdn_a, rdnd_a);
                tdbt_a = tdbt_a * ya.dbt;
            }
        }
    }
    if (!allsky) {
        ztdn_a = ztdn_c;
        rdnd_a = rdnd_c;
        tdbt_a = tdbt_c;
    }
    Fluxes fc{0.0f, 0.0f}, fa{0.0f, 0.0f};
    if (active) {
        fc = level_fluxes(tdbt_c, ztdn_c, rdnd_c, adir, adif);
        fa = level_fluxes(tdbt_a, ztdn_a, rdnd_a, adir, adif);
        sfc[0][g] = tdbt_a * z;
        sfc[1][g] = fa.fd * z;
        sfc[2][g] = fa.fu * z;
    }
    put(nlay, tdbt_c, tdbt_a, fc, fa);
    __syncthreads();

    for (int i = gt; i < NLEVF * nlev; i += BLOCK) {
        const int f = i / nlev;
        const int lev = i % nlev;
        float s = 0.0f;
        for (int k = 0; k < NWARP; ++k) s += part[(f * NWARP + k) * nlev + lev];
        lev_out[(static_cast<size_t>(f) * ncol + col) * nlev + lev] = s;
    }
    if (gt < 3 * NBND_SW) {
        // per-band surface sums, in g order: net, direct, diffuse
        const int b = gt % NBND_SW;
        const int which = gt / NBND_SW;
        float s = 0.0f;
        for (int k = ngs_sw(b); k < ngs_sw(b) + ng_sw(b); ++k)
            s += which == 0 ? sfc[1][k] - sfc[2][k]
               : which == 1 ? sfc[0][k] : sfc[1][k] - sfc[0][k];
        band_out[(static_cast<size_t>(which) * ncol + col) * NBND_SW + b] = s;
    } else if (gt < 3 * NBND_SW + 6) {
        // nirr, nirf, parr, parf, uvrr, uvrf: direct or total surface flux
        // times the NIR / PAR / UV selection (band 9 split half and half)
        const int k = gt - 3 * NBND_SW;
        const float* sel = weights + (2 + k / 2) * NGPT_SW;
        const float* x = sfc[k % 2 == 0 ? 0 : 1];
        float s = 0.0f;
        for (int j = 0; j < NGPT_SW; ++j) s += x[j] * sel[j];
        sfc_out[static_cast<size_t>(k) * ncol + col] = s;
    }
}

}  // namespace

extern "C" int spcvmc_sw(const float* taug, const float* taur,
                         const float* taucmc, const float* ssacmc,
                         const float* asmcmc, const unsigned char* cldymc,
                         const float* taua, const float* ssaa,
                         const float* asya, const float* mu0c,
                         const float* albdir, const float* albdif,
                         const float* zincflx, const float* weights,
                         float* scratch, float* lev_out, float* sfc_out,
                         float* band_out, int ncol, int nlay, int ncld,
                         void* stream) {
    if (ncol <= 0 || nlay <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * NLEVF * NWARP * (nlay + 1);
    spcvmc_kernel<<<ncol, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        taug, taur, taucmc, ssacmc, asmcmc, cldymc, taua, ssaa, asya, mu0c,
        albdir, albdif, zincflx, weights, scratch, lev_out, sfc_out,
        band_out, ncol, nlay, ncld);
    return static_cast<int>(cudaGetLastError());
}
