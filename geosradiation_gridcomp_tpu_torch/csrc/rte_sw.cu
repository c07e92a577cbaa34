// K10: RRTMGP's SW solver rte_sw for the all-sky and the clear stream.
//
// Replaces no TPU kernel: in the JAX package XLA computes this stage
// (geosradiation_gridcomp_tpu/models/rrtmgp/rte.py:rte_sw). It computes
// what the plain twin, two calls of models/rrtmgp/rte.py:rte_sw (the
// all-sky one, then one with zero cloud optics), computes: per (column,
// layer, g-point) and stream RRTMGP's delta scaling of the cloud optics
// (f = g^2, the tau > 0 guards and the clamps), the optional aerosol read
// through the g-point -> band map, w clipped to 1 - 1e-6, g_eff, the PIFM
// layer R/T of reftra_sw with 1 - w taken from the clipped w, the
// direct-beam transmittance and its running product, the two adding sweeps
// of vrtqdr_sw, and the sums over g of flux_up, flux_dn and flux_dir
// weighted by toa_src * mu0 (mu0 floored at 1e-6). It shares no source
// with K6 (csrc/spcvmc.cu), whose optics differ.
//
// Bound on the H100 at 8,100 x 72 x 112 x 2 streams: its bytes, the inputs
// (five [ncol, nlay, ngpt] float32 fields, ~1.3 GB) and the six profiles
// read and written once, 0.39 ms; K6's count of the work (7 special-function
// and 30 FP32 instructions a solve) issues in ~0.25 ms; the scratch, 28 B
// per cell, g-point and stream written and read, adds ~7 GB (~2.2 ms).
// Design, from K6's measured layout: one block per
// column, one thread per g-point (at most 128), carrying the clear and the
// all-sky stream, which share the layer's loads and, where the cell is
// clear in this g-point, the layer's R/T. The up sweep (surface -> TOA)
// stores each layer's R/T and the composite reflectances below it in a
// global scratch; the down sweep reads them back, one layer ahead, and
// forms the level fluxes. The level sums over g are staged in shared
// memory, CH levels at a time, and each thread sums one (field, level)
// over the g-points in g order, so the result is deterministic.
// Measured on the H100 at 8,100 x 72 (PERF.md): 3.81 ms of device
// time against the 0.39 ms bound of its bytes (10 %); ptxas: 76 registers,
// no spills, 37.7 KB of shared memory; SASS: 1,060 instructions a layer in
// the up sweep and 421 in the down sweep, both streams, per thread, so at
// four warps a column the card's issue alone takes ~3.5 ms: the kernel is
// issue-bound, and the scratch's ~7 GB (~2.2 ms of HBM) overlap it. Keeping
// the scratch on chip (the g-points of a column split over blocks, the sums
// then a second pass or a cluster's) would add instructions to save traffic
// that is not the limit: not built, not measured.
//
// Numerics: every product, sum and difference is written as the twin's
// PyTorch ops round it (__fmul_rn, __fadd_rn, __fsub_rn: no FMA
// contraction), the divisions are IEEE, expf and sqrtf as the twin's, so a
// g-point's fluxes are the twin's bit for bit and only the order of the sum
// over g differs. That matters where float32 cancels: in the pure-Rayleigh
// cells, w clipped at 1 - 1e-6, gamma1^2 - gamma2^2 is ~3e-6 of its terms,
// and a contracted FMA there moves zrk by ~1 %; and the conservative
// branch's predicate compares a quantity within 5e-7 of 0.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;              // one thread per g-point
constexpr int NSTREAM = 2;              // 0 all-sky, 1 clear
constexpr int NQ = 3;                   // fu, fd, direct
constexpr int NOUT = NSTREAM * NQ;      // output profiles
constexpr int CH = 12;                  // levels staged per chunk (the
                                        // stage fits 48 KB of static smem)
constexpr int GPAD = BLOCK + 1;         // staged row, padded
constexpr int NSCR = 7;                 // scratch fields per stream
constexpr float WCRIT_RESID = static_cast<float>(1.0 - 0.9999995);
constexpr float W_MAX = 0.999999f;      // the twin's clamp, 1 - 1e-6

__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}

struct Optics {
    float tau, w, g;
};

struct Layer {
    float ref, tra, refd, trad, dbt;
};

// One layer's inputs of one (column, g-point).
struct Raw {
    float tg, tr, tc, sc, gc, ta, sa, ga;
};

// rte_sw's optics of one stream: the delta-scaled cloud optics (zero in
// the clear stream) with the gas, Rayleigh and aerosol optics.
__device__ __forceinline__ Optics optics(const Raw& r, bool cloud) {
    float tau_c = 0.0f, ssa_c = 0.0f, g_c = 0.0f;
    if (cloud) {
        const float f = mul(r.gc, r.gc);
        const float one_sf = sub(1.0f, mul(r.sc, f));
        tau_c = mul(one_sf, r.tc);
        if (r.tc > 0.0f) {
            ssa_c = mul(sub(1.0f, f), r.sc) / fmaxf(one_sf, 1e-12f);
            g_c = sub(r.gc, f) / fmaxf(sub(1.0f, f), 1e-12f);
        }
    }
    float tau = add(add(r.tg, r.tr), tau_c);
    float scat = add(r.tr, mul(ssa_c, tau_c));
    float asym = mul(mul(g_c, ssa_c), tau_c);
    tau = add(tau, r.ta);
    scat = add(scat, mul(r.sa, r.ta));
    asym = add(asym, mul(mul(r.ga, r.sa), r.ta));
    Optics o;
    o.tau = tau;
    o.w = fminf(fmaxf(scat / fmaxf(tau, 1e-12f), 0.0f), W_MAX);
    o.g = asym / fmaxf(scat, 1e-12f);
    return o;
}

// PIFM reflectance/transmittance of a homogeneous layer (reftra_sw,
// kmodts=2, 1 - w from w) and its direct-beam transmittance.
__device__ Layer reftra(const Optics& o, float mu0) {
    const float tau = o.tau, w = o.w, g = o.g;
    const float womz = sub(1.0f, w);
    const float zg3 = mul(3.0f, g);
    const float gamma1 = mul(sub(8.0f, mul(w, add(5.0f, zg3))), 0.25f);
    const float gamma2 = mul(mul(3.0f, mul(w, sub(1.0f, g))), 0.25f);
    const float gamma3 = mul(sub(2.0f, mul(zg3, mu0)), 0.25f);
    const float gamma4 = sub(1.0f, gamma3);

    const float qr = g / sub(1.0f, g);
    const float q = mul(qr, qr);
    float den = sub(1.0f, mul(womz, q));
    if (fabsf(den) < 1e-12f) den = den < 0.0f ? -1e-12f : 1e-12f;
    const bool conservative = mul(womz, sub(1.0f, q)) / den <= WCRIT_RESID;

    Layer r;
    r.dbt = expf(-fminf(tau / mu0, 500.0f));
    if (conservative) {
        if (r.dbt == 1.0f) {
            r.ref = 0.0f;
            r.tra = 1.0f;
            r.refd = 0.0f;
            r.trad = 1.0f;
        } else {
            const float za1c = sub(mul(gamma1, mu0), gamma3);
            const float zgt = mul(gamma1, tau);
            const float opz = add(1.0f, zgt);
            r.ref = sub(zgt, mul(za1c, sub(1.0f, r.dbt))) / opz;
            r.tra = sub(1.0f, r.ref);
            r.refd = zgt / opz;
            r.trad = sub(1.0f, r.refd);
        }
        return r;
    }
    const float za1 = add(mul(gamma1, gamma4), mul(gamma2, gamma3));
    const float za2 = add(mul(gamma1, gamma3), mul(gamma2, gamma4));
    const float zrk = sqrtf(fmaxf(sub(mul(gamma1, gamma1),
                                      mul(gamma2, gamma2)), 1e-12f));
    const float zrp = mul(zrk, mu0);
    const float opp = add(1.0f, zrp);
    const float s = sub(1.0f, zrp);
    const float zrkg = add(zrk, gamma1);
    const float g3k = mul(zrk, gamma3);
    const float g4k = mul(zrk, gamma4);
    const float zbeta = sub(gamma1, zrk) / zrkg;

    const float ze1 = fminf(mul(zrk, tau), 5.0f);
    const float ze2 = fminf(tau / mu0, 5.0f);
    const float zem1 = expf(-ze1);
    const float zep1 = expf(ze1);
    const float zem2 = expf(-ze2);
    const float zep2 = expf(ze2);

    const float u = sub(ze2, ze1);
    const float rr = fabsf(s) >= 1e-6f ? u / s : (u == 0.0f ? 0.0f : ze2);
    float psi_p, psi_m;
    if (fabsf(u) <= 0.01f) {
        const float sixth = static_cast<float>(1.0 / 6.0);
        psi_p = add(1.0f, mul(u, add(0.5f, mul(u, sixth))));
        psi_m = sub(1.0f, mul(u, sub(0.5f, mul(u, sixth))));
    } else {
        psi_p = sub(expf(u), 1.0f) / u;
        psi_m = -sub(expf(-u), 1.0f) / u;
    }
    const float zden = mul(opp, add(mul(zrkg, zep1),
                                    mul(sub(zrk, gamma1), zem1)));
    r.ref = mul(w, add(mul(add(za2, g3k), sub(zep1, zem2)),
                       mul(mul(mul(mul(sub(g3k, za2), opp), zem2), rr),
                           psi_p))) / zden;
    r.tra = mul(zem2, sub(1.0f, mul(w, sub(mul(sub(za1, g4k),
                                               sub(zep2, zem1)),
                                           mul(mul(mul(mul(add(za1, g4k),
                                                           opp), zep2), rr),
                                               psi_m))) / zden));
    const float zemm = mul(zem1, zem1);
    const float zdend = 1.0f / mul(sub(1.0f, mul(zbeta, zemm)), zrkg);
    r.refd = mul(mul(gamma2, sub(1.0f, zemm)), zdend);
    r.trad = mul(mul(mul(2.0f, zrk), zem1), zdend);
    return r;
}

// Composite reflectances seen from a level, adding one layer below
// (vrtqdr_sw's surface -> TOA recursion).
__device__ __forceinline__ void add_below(const Layer& y, float& rup,
                                          float& rupd) {
    const float zrefl = 1.0f / sub(1.0f, mul(rupd, y.refd));
    const float rup_n = add(y.ref, mul(mul(y.trad, add(mul(sub(y.tra, y.dbt),
                                                           rupd),
                                                       mul(y.dbt, rup))),
                                       zrefl));
    rupd = add(y.refd, mul(mul(mul(y.trad, y.trad), rupd), zrefl));
    rup = rup_n;
}

// Transmittance and diffuse reflectance from above, adding one layer
// (vrtqdr_sw's TOA -> surface recursion); tdb = direct transmittance above.
__device__ __forceinline__ void add_above(const Layer& y, float tdb,
                                          float& ztdn, float& rdnd) {
    const float zrefl = 1.0f / sub(1.0f, mul(y.refd, rdnd));
    const float ztdn_n = add(mul(tdb, y.tra),
                             mul(mul(y.trad, add(sub(ztdn, tdb),
                                                 mul(mul(tdb, y.ref), rdnd))),
                                 zrefl));
    rdnd = add(y.refd, mul(mul(mul(y.trad, y.trad), rdnd), zrefl));
    ztdn = ztdn_n;
}

struct Fluxes {
    float fd, fu;
};

__device__ __forceinline__ Fluxes level_fluxes(float tdbt, float ztdn,
                                               float rdnd, float rup,
                                               float rupd) {
    const float zrefl = 1.0f / sub(1.0f, mul(rdnd, rupd));
    Fluxes f;
    f.fu = mul(add(mul(tdbt, rup), mul(sub(ztdn, tdbt), rupd)), zrefl);
    f.fd = add(tdbt, mul(add(sub(ztdn, tdbt), mul(mul(tdbt, rup), rdnd)),
                         zrefl));
    return f;
}

struct Scr {
    float rup, rupd;
    Layer y;
};

struct Args {
    const float* taug;      // [ncol, nlay, ngpt]
    const float* taur;
    const float* tau_cld;
    const float* ssa_cld;
    const float* g_cld;
    const float* tau_aer;   // [ncol, nlay, nbnd], or null
    const float* ssa_aer;   // or null: 1
    const float* g_aer;     // or null: 0
    const float* toa_src;   // [ncol, ngpt]
    const float* mu0;       // [ncol]
    const float* alb_dir;   // [ncol, nbnd]
    const float* alb_dif;
    const long long* band;  // [ngpt] g-point -> band
    float* scratch;         // [ncol, nlay, 2, 7, ngpt]
    float* out;             // [6, ncol, nlay + 1]
    int ncol, nlay, ngpt, nbnd;
};

__global__ void __launch_bounds__(BLOCK) rte_sw_kernel(const Args a) {
    // per-stream fu, fd, direct flux of CH levels: [stream][3][CH][GPAD]
    __shared__ float stage[NSTREAM * NQ * CH * GPAD];
    __shared__ float wz[BLOCK];             // toa_src * mu0, per g-point

    const int col = blockIdx.x;
    const int t = threadIdx.x;
    const int ngpt = a.ngpt, nlay = a.nlay, nlev = nlay + 1;
    const bool active = t < ngpt;
    const int g = active ? t : 0;
    const int band = static_cast<int>(a.band[g]);
    const float mu0 = fmaxf(a.mu0[col], 1e-6f);
    if (active)
        wz[g] = mul(a.toa_src[static_cast<size_t>(col) * ngpt + g], mu0);
    const float adir = a.alb_dir[static_cast<size_t>(col) * a.nbnd + band];
    const float adif = a.alb_dif[static_cast<size_t>(col) * a.nbnd + band];

    const size_t cg = static_cast<size_t>(col) * nlay * ngpt + g;
    const size_t ca = static_cast<size_t>(col) * nlay * a.nbnd + band;
    auto load = [&](int l) {
        const size_t i = cg + static_cast<size_t>(l) * ngpt;
        Raw r;
        r.tg = a.taug[i];
        r.tr = a.taur[i];
        r.tc = a.tau_cld[i];
        r.sc = a.ssa_cld[i];
        r.gc = a.g_cld[i];
        r.ta = 0.0f;
        r.sa = 1.0f;
        r.ga = 0.0f;
        if (a.tau_aer != nullptr) {
            const size_t j = ca + static_cast<size_t>(l) * a.nbnd;
            r.ta = a.tau_aer[j];
            if (a.ssa_aer != nullptr) r.sa = a.ssa_aer[j];
            if (a.g_aer != nullptr) r.ga = a.g_aer[j];
        }
        return r;
    };
    // scratch rows of this column: [nlay][stream][NSCR][ngpt]
    const size_t lstride = static_cast<size_t>(NSTREAM) * NSCR * ngpt;
    float* scr = a.scratch + static_cast<size_t>(col) * nlay * lstride + g;
    auto scr_at = [&](int l, int s) {
        return scr + l * lstride + s * NSCR * ngpt;
    };
    auto load_scr = [&](int l, int s) {
        const float* o = scr_at(l, s);
        Scr x;
        x.rup = o[0];
        x.rupd = o[ngpt];
        x.y.ref = o[2 * ngpt];
        x.y.tra = o[3 * ngpt];
        x.y.refd = o[4 * ngpt];
        x.y.trad = o[5 * ngpt];
        x.y.dbt = o[6 * ngpt];
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
        Raw next = load(nlay - 1);
        for (int l = nlay - 1; l >= 0; --l) {
            const Raw cur = next;
            if (l > 0) next = load(l - 1);
            Layer y[NSTREAM];
            y[1] = reftra(optics(cur, false), mu0);
            // a cell clear in this g-point has the clear stream's optics,
            // bit for bit: zero cloud optics add +0 to tau and scat
            y[0] = cur.tc == 0.0f ? y[1] : reftra(optics(cur, true), mu0);
#pragma unroll
            for (int s = 0; s < NSTREAM; ++s) {
                add_below(y[s], rup[s], rupd[s]);
                float* o = scr_at(l, s);
                o[0] = rup[s];
                o[ngpt] = rupd[s];
                o[2 * ngpt] = y[s].ref;
                o[3 * ngpt] = y[s].tra;
                o[4 * ngpt] = y[s].refd;
                o[5 * ngpt] = y[s].trad;
                o[6 * ngpt] = y[s].dbt;
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
        if (active) snext[s] = load_scr(0, s);
    }
    for (int l0 = 0; l0 < nlev; l0 += CH) {
        const int nk = nlev - l0 < CH ? nlev - l0 : CH;
        if (active) {
            for (int k = 0; k < nk; ++k) {
                const int l = l0 + k;
                const bool sfc = l == nlay;
                Scr sc[NSTREAM];
#pragma unroll
                for (int s = 0; s < NSTREAM; ++s) {
                    sc[s] = snext[s];
                    if (l + 1 < nlay) snext[s] = load_scr(l + 1, s);
                }
#pragma unroll
                for (int s = 0; s < NSTREAM; ++s) {
                    const Fluxes f = level_fluxes(
                        tdbt[s], ztdn[s], rdnd[s], sfc ? adir : sc[s].rup,
                        sfc ? adif : sc[s].rupd);
                    float* st = stage + s * NQ * CH * GPAD + g;
                    st[k * GPAD] = f.fu;
                    st[(CH + k) * GPAD] = f.fd;
                    st[(2 * CH + k) * GPAD] = tdbt[s];
                    if (sfc) continue;
                    add_above(sc[s].y, tdbt[s], ztdn[s], rdnd[s]);
                    tdbt[s] = mul(tdbt[s], sc[s].y.dbt);
                }
            }
        }
        __syncthreads();
        // thread t sums profile t / CH of level l0 + t % CH over g, in order
        const int fld = t / CH, k = t % CH;
        if (fld < NOUT && k < nk) {
            const float* v = stage + fld * CH * GPAD + k * GPAD;
            float acc = 0.0f;
            for (int j = 0; j < ngpt; ++j) acc = add(acc, mul(v[j], wz[j]));
            a.out[(static_cast<size_t>(fld) * a.ncol + col) * nlev + l0 + k]
                = acc;
        }
        __syncthreads();
    }
}

}  // namespace

// out: [6, ncol, nlay + 1], all-sky flux_up, flux_dn, flux_dir, then the
// clear sky's; scratch: [ncol, nlay, 2, 7, ngpt], per (layer, stream) the
// composite reflectances below its top and the layer's ref, tra, refd, trad
// and direct transmittance.
extern "C" int rte_sw(const float* taug, const float* taur,
                      const float* tau_cld, const float* ssa_cld,
                      const float* g_cld, const float* tau_aer,
                      const float* ssa_aer, const float* g_aer,
                      const float* toa_src, const float* mu0,
                      const float* alb_dir, const float* alb_dif,
                      const long long* band, float* scratch, float* out,
                      int ncol, int nlay, int ngpt, int nbnd, void* stream) {
    if (ncol <= 0 || nlay <= 0 || ngpt <= 0 || ngpt > BLOCK || nbnd <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{taug, taur, tau_cld, ssa_cld, g_cld, tau_aer, ssa_aer,
                 g_aer, toa_src, mu0, alb_dir, alb_dif, band, scratch, out,
                 ncol, nlay, ngpt, nbnd};
    rte_sw_kernel<<<ncol, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
