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
// Bound on the H100: issue of the serial per-layer chain. One reftra (7
// expf, ~10 divisions, a sqrtf) per (cell, g-point, stream) is ~400
// instructions; the inputs (~25 B per cell and g-point, ~0.3 GB at 3840 x
// 72 x 112) and the scratch (28 B per cell, g-point and stream written and
// read, ~3 GB) move in ~1 ms at 3.35 TB/s. Design: one block per column,
// one thread per g-point (112 of 128) carrying the clear and the all-sky
// stream, which share the layer's loads and clear optics and give the
// scheduler two independent chains per thread. On columns at or past ncld
// the all-sky stream idles and its level sums are the clear stream's (the
// oracle's alias). The up sweep (surface -> TOA) stores each layer's R/T
// and the composite reflectances below it in a global scratch; the down
// sweep reads them back and forms the level fluxes. (Recomputing the R/T
// in the down sweep, and one thread per (g-point, stream), were measured
// slower: PERF.md.) Each layer's inputs and scratch rows are loaded one
// layer ahead, in registers. The level sums over g are taken out of the
// sweep: each stream stages its fu, fd and direct flux for a chunk of CH
// levels in shared memory, then each thread sums one (field, level) over
// the 112 g-points in g order, so the result is deterministic.
// Numerics: expf, never __expf, and exp(x) rather than 1/exp(-x), as the
// oracle; the products in 1 - w and in the conservative predicate use
// __fmul_rn/__fadd_rn so no FMA contraction moves a cell across the branch,
// and the divisions that decide the branch (and the optics) are IEEE; the
// divisions after it (reftra's branches, the adding recursions) use
// __fdividef (2 ulp), far inside the kernel's 5e-4 parity gate: IEEE
// division there made the kernel ~12 % slower (PERF.md). Their
// denominators stay far below 2^126, where __fdividef would return 0:
// 1 + gamma1 tau grows only with the optical depth, the exponentials in
// the others are capped by the clamps of ze1 and ze2 at 5, and the adding
// denominators lie in (0, 1].

#include "common.cuh"

namespace {

using namespace geosrad;

constexpr int NSTREAM = 2;                  // clear, all-sky
constexpr int BLOCK = 128;                  // one thread per g-point
constexpr int NLEVF = 14;                   // level fields, LEVEL_KEYS order
constexpr int CH = BLOCK / NLEVF;           // levels staged per chunk: one
                                            // (field, level) sum per thread
constexpr int GPAD = NGPT_SW + 1;           // staged row, padded
constexpr int NSCR = 7;                     // scratch fields per stream
constexpr float WCRIT_RESID = static_cast<float>(1.0 - 0.9999995);

__device__ __forceinline__ float fdiv(float a, float b) {
    return __fdividef(a, b);
}

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
            r.ref = fdiv(zgt - za1c * (1.0f - ze2c), 1.0f + zgt);
            r.tra = 1.0f - r.ref;
            r.refd = fdiv(zgt, 1.0f + zgt);
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
    const float zbeta = fdiv(gamma1 - zrk, zrkg);

    const float ze1 = fminf(zrk * tau, 5.0f);
    const float ze2 = fminf(tau / mu0, 5.0f);
    const float zem1 = expf(-ze1);
    const float zep1 = expf(ze1);
    const float zem2 = expf(-ze2);
    const float zep2 = expf(ze2);

    const float u = ze2 - ze1;
    const float rr = fabsf(s) >= 1e-6f ? fdiv(u, s) : (u == 0.0f ? 0.0f : ze2);
    float psi_p, psi_m;
    if (fabsf(u) <= 0.01f) {
        psi_p = 1.0f + u * (0.5f + u * (1.0f / 6.0f));
        psi_m = 1.0f - u * (0.5f - u * (1.0f / 6.0f));
    } else {
        psi_p = fdiv(expf(u) - 1.0f, u);
        psi_m = -fdiv(expf(-u) - 1.0f, u);
    }
    const float zden = opp * (zrkg * zep1 + (zrk - gamma1) * zem1);
    r.ref = fdiv(w * ((za2 + g3k) * (zep1 - zem2)
                      + (g3k - za2) * opp * zem2 * rr * psi_p), zden);
    r.tra = zem2 * (1.0f - fdiv(w * ((za1 - g4k) * (zep2 - zem1)
                                     - (za1 + g4k) * opp * zep2 * rr * psi_m),
                                zden));
    const float zemm = zem1 * zem1;
    const float zdend = fdiv(1.0f, (1.0f - zbeta * zemm) * zrkg);
    r.refd = gamma2 * (1.0f - zemm) * zdend;
    r.trad = 2.0f * zrk * zem1 * zdend;
    return r;
}

// One layer's inputs of one (column, g-point): gas and Rayleigh depths,
// the band's aerosol optics and, where the all-sky stream sees cloud, the
// McICA cloud optics.
struct Raw {
    float tg, tr, ta, sa, ya, tc, sc, ac;
    bool cloudy;
};

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
    bool cloud;             // read the cloud optics (an all-sky stream runs)

    __device__ Raw load(int l) const {
        const size_t i = static_cast<size_t>(l) * NGPT_SW + g;
        Raw r;
        r.tg = taug[i];
        r.tr = taur[i];
        r.ta = r.sa = r.ya = 0.0f;
        if (taua != nullptr) {
            const size_t j = static_cast<size_t>(l) * NBND_SW + band;
            r.ta = taua[j];
            r.sa = ssaa[j];
            r.ya = asya[j];
        }
        r.cloudy = cloud && cldymc[i];
        r.tc = r.sc = r.ac = 0.0f;
        if (r.cloudy) {
            r.tc = taucmc[i];
            r.sc = ssacmc[i];
            r.ac = asmcmc[i];
        }
        return r;
    }
};

// clear-sky delta-scaled optics of a layer (spcvmc.F90:340-356)
__device__ __forceinline__ Optics clear_optics(const Raw& r) {
    const float tg = r.tg, tr = r.tr, ta = r.ta, sa = r.sa, ya = r.ya;
    const float ztauo = __fadd_rn(__fadd_rn(tr, tg), ta);
    float zomco = __fadd_rn(tr, __fmul_rn(ta, sa));
    const float zgco = __fmul_rn(__fmul_rn(ya, sa), ta) / fmaxf(zomco, 1e-30f);
    zomco = zomco / ztauo;
    const float zf = __fmul_rn(zgco, zgco);
    const float zwf = __fmul_rn(zomco, zf);
    Optics c;
    c.tau = __fmul_rn(__fsub_rn(1.0f, zwf), ztauo);
    c.w = __fsub_rn(zomco, zwf) / __fsub_rn(1.0f, zwf);
    c.g = __fsub_rn(zgco, zf) / __fsub_rn(1.0f, zf);
    // 1 - w at full relative precision: absorption / total
    c.womz = __fadd_rn(tg, __fmul_rn(ta, __fsub_rn(1.0f, sa))) / ztauo
           / __fsub_rn(1.0f, zwf);
    return c;
}

// the clear optics c with the McICA cloud optics of r added
__device__ __forceinline__ Optics add_cloud(const Optics& c, const Raw& r) {
    const float tcs = __fmul_rn(r.tc, r.sc);
    const float tgc = __fadd_rn(__fmul_rn(__fmul_rn(c.tau, c.w), c.g),
                                __fmul_rn(tcs, r.ac));
    const float to = __fadd_rn(__fmul_rn(c.tau, c.w), tcs);
    const float tt = __fadd_rn(c.tau, r.tc);
    Optics o;
    o.tau = tt;
    o.w = to / tt;
    o.g = tgc / fmaxf(to, 1e-30f);
    o.womz = __fadd_rn(__fmul_rn(c.tau, c.womz),
                       __fmul_rn(r.tc, __fsub_rn(1.0f, r.sc))) / tt;
    return o;
}

// Composite reflectances seen from a level, adding one layer below
// (vrtqdr_sw's surface->TOA recursion).
__device__ __forceinline__ void add_below(const Layer& y, float& rup,
                                          float& rupd) {
    const float zrefl = fdiv(1.0f, 1.0f - rupd * y.refd);
    const float rup_n = y.ref + y.trad * ((y.tra - y.dbt) * rupd
                                          + y.dbt * rup) * zrefl;
    rupd = y.refd + y.trad * y.trad * rupd * zrefl;
    rup = rup_n;
}

// Transmittance and diffuse reflectance from above, adding one layer
// (vrtqdr_sw's TOA->surface recursion); tdb = direct transmittance above.
__device__ __forceinline__ void add_above(const Layer& y, float tdb,
                                          float& ztdn, float& rdnd) {
    const float zrefl = fdiv(1.0f, 1.0f - y.refd * rdnd);
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
    const float zrefl = fdiv(1.0f, 1.0f - rdnd * rupd);
    Fluxes f;
    f.fu = (tdbt * rup + (ztdn - tdbt) * rupd) * zrefl;
    f.fd = tdbt + (ztdn - tdbt + tdbt * rup * rdnd) * zrefl;
    return f;
}

// Level field f of LEVEL_KEYS: its stream (0 clear, 1 all-sky), the
// staged quantity (0 fu, 1 fd, 2 direct flux) and its weight (0 the
// incident flux, 1 its UV part, 2 its NIR part).
__device__ __forceinline__ void level_field(int f, int& s, int& q, int& w) {
    // bbfu bbfd bbcu bbcd bbfddir bbcddir, then uv/ni fd cd fddir cddir
    s = f < 4 ? (f < 2 ? 1 : 0) : (f % 2 == 0 ? 1 : 0);
    q = f < 4 ? f % 2 : (f < 6 ? 2 : (f - 6) % 4 < 2 ? 1 : 2);
    w = f < 6 ? 0 : (f < 10 ? 1 : 2);
}

// A thread's view of one scratch row: the composite reflectances below a
// level and the layer's R/T.
struct Scr {
    float rup, rupd;
    Layer y;
};

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
    // per-stream fu, fd, direct flux of CH levels: [stream][3][CH][GPAD]
    __shared__ float stage[NSTREAM * 3 * CH * GPAD];
    __shared__ float wz[3][NGPT_SW];       // incident flux: all, UV, NIR
    __shared__ float sfc[3][NGPT_SW];      // surface dir, tot, up (all-sky)

    const int col = blockIdx.x;
    const int t = threadIdx.x;
    // this thread's g-point
    const bool active = t < NGPT_SW;
    const int g = active ? t : 0;
    const int band = band_of_sw(g);
    const int nlev = nlay + 1;
    const bool allsky_col = col < ncld;
    // stream s runs unless it is the all-sky stream of a column past ncld,
    // which aliases the clear one
    const bool run[NSTREAM] = {active, active && allsky_col};
    const float mu0 = mu0c[col];
    const float z = active ? zincflx[static_cast<size_t>(col) * NGPT_SW + g]
                           : 0.0f;
    if (active) {
        wz[0][g] = z;
        wz[1][g] = z * weights[g];
        wz[2][g] = z * weights[NGPT_SW + g];
    }
    const float adir = albdir[col * NBND_SW + band];
    const float adif = albdif[col * NBND_SW + band];

    const size_t cg = static_cast<size_t>(col) * nlay * NGPT_SW;
    const size_t ca = static_cast<size_t>(col) * nlay * NBND_SW;
    const bool aero = taua != nullptr;
    const Point p{taug + cg, taur + cg, taucmc + cg, ssacmc + cg,
                  asmcmc + cg, cldymc + cg, aero ? taua + ca : nullptr,
                  aero ? ssaa + ca : nullptr, aero ? asya + ca : nullptr, g,
                  band, allsky_col};
    // the layer's optics seen by stream s
    auto optics = [&](const Raw& r, const Optics& c, int s) {
        return s == 1 && r.cloudy ? add_cloud(c, r) : c;
    };
    // scratch rows of this column: [nlay][stream][NSCR][112]
    const size_t lstride = static_cast<size_t>(NSTREAM) * NSCR * NGPT_SW;
    float* scr = scratch + static_cast<size_t>(col) * nlay * lstride + g;
    auto scr_at = [&](int l, int s) {
        return scr + l * lstride + s * NSCR * NGPT_SW;
    };
    auto load_scr = [&](int l, int s) {
        const float* o = scr_at(l, s);
        Scr x;
        x.rup = o[0];
        x.rupd = o[NGPT_SW];
        x.y.ref = o[2 * NGPT_SW];
        x.y.tra = o[3 * NGPT_SW];
        x.y.refd = o[4 * NGPT_SW];
        x.y.trad = o[5 * NGPT_SW];
        x.y.dbt = o[6 * NGPT_SW];
        return x;
    };

    // ---- up sweep (surface -> TOA): composite below each level ----
    if (active) {
        float rup[NSTREAM], rupd[NSTREAM];
#pragma unroll
        for (int s = 0; s < NSTREAM; ++s) {
            rup[s] = adir;
            rupd[s] = adif;
        }
        Raw next = p.load(nlay - 1);
        for (int l = nlay - 1; l >= 0; --l) {
            const Raw cur = next;
            if (l > 0) next = p.load(l - 1);
            const Optics oc = clear_optics(cur);
#pragma unroll
            for (int s = 0; s < NSTREAM; ++s) {
                if (!run[s]) continue;
                const Layer y = reftra(optics(cur, oc, s), mu0);
                add_below(y, rup[s], rupd[s]);
                float* o = scr_at(l, s);
                o[0] = rup[s];
                o[NGPT_SW] = rupd[s];
                o[2 * NGPT_SW] = y.ref;
                o[3 * NGPT_SW] = y.tra;
                o[4 * NGPT_SW] = y.refd;
                o[5 * NGPT_SW] = y.trad;
                o[6 * NGPT_SW] = y.dbt;
            }
        }
    }

    // ---- down sweep (TOA -> surface), CH levels at a time ----
    float ztdn[NSTREAM], rdnd[NSTREAM], tdbt[NSTREAM];
    Scr snext[NSTREAM];
#pragma unroll
    for (int s = 0; s < NSTREAM; ++s) {
        ztdn[s] = 1.0f;
        rdnd[s] = 0.0f;
        tdbt[s] = 1.0f;
        if (run[s]) snext[s] = load_scr(0, s);
    }
    for (int l0 = 0; l0 < nlev; l0 += CH) {
        const int nk = nlev - l0 < CH ? nlev - l0 : CH;
        if (active) {
            for (int k = 0; k < nk; ++k) {
                const int l = l0 + k;
                const bool sfc_lev = l == nlay;
                Scr sc[NSTREAM];
#pragma unroll
                for (int s = 0; s < NSTREAM; ++s) {
                    sc[s] = snext[s];
                    if (run[s] && l + 1 < nlay) snext[s] = load_scr(l + 1, s);
                }
#pragma unroll
                for (int s = 0; s < NSTREAM; ++s) {
                    if (!run[s]) continue;
                    const Fluxes f = level_fluxes(
                        tdbt[s], ztdn[s], rdnd[s], sfc_lev ? adir : sc[s].rup,
                        sfc_lev ? adif : sc[s].rupd);
                    float* st = stage + s * 3 * CH * GPAD + g;
                    st[k * GPAD] = f.fu;
                    st[(CH + k) * GPAD] = f.fd;
                    st[(2 * CH + k) * GPAD] = tdbt[s];
                    if (sfc_lev) {
                        if (s == (allsky_col ? 1 : 0)) {
                            sfc[0][g] = tdbt[s] * z;
                            sfc[1][g] = f.fd * z;
                            sfc[2][g] = f.fu * z;
                        }
                        continue;
                    }
                    add_above(sc[s].y, tdbt[s], ztdn[s], rdnd[s]);
                    tdbt[s] = tdbt[s] * sc[s].y.dbt;
                }
            }
        }
        __syncthreads();
        // thread t sums field t / CH of level l0 + t % CH over g, in order
        const int fld = t / CH, k = t % CH;
        if (fld < NLEVF && k < nk) {
            int fs, q, w;
            level_field(fld, fs, q, w);
            if (!allsky_col) fs = 0;
            const float* v = stage + (fs * 3 + q) * CH * GPAD + k * GPAD;
            const float* wt = wz[w];
            float acc = 0.0f;
            for (int j = 0; j < NGPT_SW; ++j) acc += v[j] * wt[j];
            lev_out[(static_cast<size_t>(fld) * ncol + col) * nlev + l0 + k]
                = acc;
        }
        __syncthreads();
    }

    if (t < 3 * NBND_SW) {
        // per-band surface sums, in g order: net, direct, diffuse
        const int b = t % NBND_SW;
        const int which = t / NBND_SW;
        float acc = 0.0f;
        for (int k = ngs_sw(b); k < ngs_sw(b) + ng_sw(b); ++k)
            acc += which == 0 ? sfc[1][k] - sfc[2][k]
                 : which == 1 ? sfc[0][k] : sfc[1][k] - sfc[0][k];
        band_out[(static_cast<size_t>(which) * ncol + col) * NBND_SW + b] = acc;
    } else if (t < 3 * NBND_SW + 6) {
        // nirr, nirf, parr, parf, uvrr, uvrf: direct or total surface flux
        // times the NIR / PAR / UV selection (band 9 split half and half)
        const int k = t - 3 * NBND_SW;
        const float* sel = weights + (2 + k / 2) * NGPT_SW;
        const float* x = sfc[k % 2 == 0 ? 0 : 1];
        float acc = 0.0f;
        for (int j = 0; j < NGPT_SW; ++j) acc += x[j] * sel[j];
        sfc_out[static_cast<size_t>(k) * ncol + col] = acc;
    }
}

}  // namespace

// scratch: [ncol, nlay, 2, 7, 112], per (layer, stream) rup, rupd and the
// layer's ref, tra, refd, trad and direct transmittance.
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
    if (ncol <= 0 || nlay <= 0 || ncld < 0 || ncld > ncol)
        return static_cast<int>(cudaErrorInvalidValue);
    spcvmc_kernel<<<ncol, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        taug, taur, taucmc, ssacmc, asmcmc, cldymc, taua, ssaa, asya, mu0c,
        albdir, albdif, zincflx, weights, scratch, lev_out, sfc_out,
        band_out, ncol, nlay, ncld);
    return static_cast<int>(cudaGetLastError());
}
