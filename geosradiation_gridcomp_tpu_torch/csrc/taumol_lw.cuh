// The body of K3 (taumol_lw.cu) and of its cost bisection P3
// (taumol_lw_bisect.cu): RRTMG-LW gas optical depths and Planck fractions,
// templated on a mask of the parts that are computed. A part that is off
// contributes 0 in place of its terms, and the compiler drops its table
// reads:
//   MAJOR   the major-species terms (major1, Major2, Major2Up);
//   MINOR   minor species and halocarbons (minor, eminor, halo);
//   CONT    the self and foreign continua (tauself, taufor);
//   PLANCK  the Planck fractions (planck_eta and the fracref rows).
// With every part on (ALL) the kernel is K3. Everything here has internal
// linkage, so each source that includes it compiles its own copy.
#pragma once

#include "common.cuh"

namespace {

using namespace geosrad;

enum Part : unsigned { MAJOR = 1, MINOR = 2, CONT = 4, PLANCK = 8, ALL = 15 };

constexpr float ONEMINUS = static_cast<float>(1.0 - 1.0e-6);
constexpr int NCHI = 59;

// per-band table slots (BAND_KEYS in models/rrtmg/taumol_lw.py)
enum Key {
    ABSA, ABSB, FRACA, FRACB, KA_MN2, KB_MN2, KA_MN2O, KB_MN2O, KA_MO3,
    KB_MO3, KA_MCO2, KB_MCO2, KA_MCO, KA_MO2, KB_MO2, CCL4, CFC11ADJ, CFC12,
    CFC22ADJ, NKEY
};
constexpr int NOFFSETS = 16 * NKEY + 3;   // + chi_mls, self10, for4

// per-cell float planes (FLOAT_FIELDS in models/rrtmg/taumol_lw_cuda.py)
enum FField {
    FAC00, FAC01, FAC10, FAC11, SELFFAC, SELFFRAC, FORFAC, FORFRAC,
    MINORFRAC, SCALEMINOR, SCALEMINORN2, COLDRY, COLBRD, COLH2O, COLCO2,
    COLO3, COLN2O, COLCH4, COLO2, COLCO, COLCFC11, COLCFC12, COLCFC22,
    COLCCL4, PAVEL, NFF
};
// per-cell int planes (INT_FIELDS)
enum IField { LOWER, JP, JT, JT1, INDSELF, INDFOR, INDMINOR, NIF };
// chi_mls species rows
enum Gas { H2O, CO2, O3, N2O, CO, CH4, O2 };

__host__ __device__ constexpr int ng_of(int b) {
    return b == 1 ? 10 : b == 2 ? 12 : b == 3 ? 16 : b == 4 ? 14
         : b == 5 ? 16 : b == 6 ? 8 : b == 7 ? 12 : b == 8 ? 8
         : b == 9 ? 12 : b == 10 ? 6 : b == 11 ? 8 : b == 12 ? 8
         : b == 13 ? 4 : 2;
}
__host__ __device__ constexpr int ngs_of(int b) {
    return b <= 1 ? 0 : ngs_of(b - 1) + ng_of(b - 1);
}
__host__ __device__ constexpr int nspa_of(int b) {
    return (b == 3 || b == 4 || b == 5 || b == 7 || b == 9 || b == 12
            || b == 13 || b == 15 || b == 16) ? 9 : 1;
}
__host__ __device__ constexpr int nspb_of(int b) {
    return (b == 3 || b == 4 || b == 5) ? 5 : 1;
}

struct Cell {
    const float* f;      // this cell's float planes [NFF] (shared memory)
    const int* i;        // its int planes [NIF] (shared memory)
    const float* P;      // packed tables
    const int* ob;       // this band's table offsets [NKEY]
    const float* chi;    // chi_mls (7, 59)
    const float* self10; // (10, 140)
    const float* for4;   // (4, 140)

    __device__ const float* tab(int key) const { return P + ob[key]; }
    __device__ float col(int gas) const {
        switch (gas) {
            case H2O: return f[COLH2O];
            case CO2: return f[COLCO2];
            case O3: return f[COLO3];
            case N2O: return f[COLN2O];
            case CO: return f[COLCO];
            case CH4: return f[COLCH4];
            default: return f[COLO2];
        }
    }
    // chi_mls(gas1, j) / chi_mls(gas2, j), j 0-based
    __device__ float ratio(int gas1, int gas2, int j) const {
        return chi[gas1 * NCHI + j] / chi[gas2 * NCHI + j];
    }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// element (row r clamped to the table, column g) of a (rows, ng) table
__device__ __forceinline__ float at(const float* t, int rows, int ng, int r,
                                    int g) {
    return t[clampi(r, 0, rows - 1) * ng + g];
}

// t[ind-1] + frac * (t[ind] - t[ind-1]), ind 1-based
__device__ __forceinline__ float interp(const float* t, int rows, int ng,
                                        int ind, float frac, int g) {
    const float t0 = at(t, rows, ng, ind - 1, g);
    return t0 + frac * (at(t, rows, ng, ind, g) - t0);
}

struct Spec {
    float sc;   // speccomb
    float sp;   // specparm
    float fs;
    int js;     // 1-based eta index
};

__device__ __forceinline__ Spec spec(float c1, float c2, float rat,
                                     float mult) {
    Spec s;
    s.sc = c1 + rat * c2;
    s.sp = fminf(c1 / s.sc, ONEMINUS);
    const float sm = mult * s.sp;
    const float fl = floorf(sm);
    s.js = 1 + static_cast<int>(fl);
    s.fs = sm - fl;
    return s;
}

// Lower 2-species key tau with the 3-branch eta interpolation
// (rrtmg_lw_taumol.F90:543-599); ib is the 0-based row of (jp', jt', js).
__device__ __forceinline__ float tau2sp(const float* a, int rows, int ng,
                                        int g, const Spec& s, int ib,
                                        float f0, float f1) {
    float tau;
    if (s.sp < 0.125f) {
        const float p = s.fs - 1.0f;
        const float p2 = p * p;
        const float p4 = p2 * p2;
        const float k0 = p4, k1 = 1.0f - p - 2.0f * p4, k2 = p + p4;
        tau = k0 * f0 * at(a, rows, ng, ib, g)
            + k1 * f0 * at(a, rows, ng, ib + 1, g)
            + k2 * f0 * at(a, rows, ng, ib + 2, g)
            + k0 * f1 * at(a, rows, ng, ib + 9, g)
            + k1 * f1 * at(a, rows, ng, ib + 10, g)
            + k2 * f1 * at(a, rows, ng, ib + 11, g);
    } else if (s.sp > 0.875f) {
        const float p = -s.fs;
        const float p2 = p * p;
        const float p4 = p2 * p2;
        const float k0 = p4, k1 = 1.0f - p - 2.0f * p4, k2 = p + p4;
        tau = k2 * f0 * at(a, rows, ng, ib - 1, g)
            + k1 * f0 * at(a, rows, ng, ib, g)
            + k0 * f0 * at(a, rows, ng, ib + 1, g)
            + k2 * f1 * at(a, rows, ng, ib + 8, g)
            + k1 * f1 * at(a, rows, ng, ib + 9, g)
            + k0 * f1 * at(a, rows, ng, ib + 10, g);
    } else {
        tau = (1.0f - s.fs) * f0 * at(a, rows, ng, ib, g)
            + s.fs * f0 * at(a, rows, ng, ib + 1, g)
            + (1.0f - s.fs) * f1 * at(a, rows, ng, ib + 9, g)
            + s.fs * f1 * at(a, rows, ng, ib + 10, g);
    }
    return s.sc * tau;
}

// Upper 2-species key tau (5 eta points, linear).
__device__ __forceinline__ float tau2sp_up(const float* b, int rows, int ng,
                                           int g, const Spec& s, int ib,
                                           float f0, float f1) {
    const float tau = (1.0f - s.fs) * f0 * at(b, rows, ng, ib, g)
                    + s.fs * f0 * at(b, rows, ng, ib + 1, g)
                    + (1.0f - s.fs) * f1 * at(b, rows, ng, ib + 5, g)
                    + s.fs * f1 * at(b, rows, ng, ib + 6, g);
    return s.sc * tau;
}

// (neta, 19, ng) minor table, bilinear in (eta, T-index); 1-based jm, indm
__device__ __forceinline__ float eta_minor(const float* t, int neta, int ng,
                                           int g, const Spec& m, int indm,
                                           float mfrac) {
    const int rows = neta * 19;
    const int r = (m.js - 1) * 19 + (indm - 1);
    const float a00 = at(t, rows, ng, r, g);
    const float a10 = at(t, rows, ng, r + 19, g);
    const float a01 = at(t, rows, ng, r + 1, g);
    const float a11 = at(t, rows, ng, r + 20, g);
    const float m1 = a00 + m.fs * (a10 - a00);
    const float m2 = a01 + m.fs * (a11 - a01);
    return m1 + mfrac * (m2 - m1);
}

// (neta, ng) Planck-fraction table at the eta index of m
__device__ __forceinline__ float planck_eta(const float* t, int neta, int ng,
                                            int g, const Spec& m) {
    const float t0 = at(t, neta, ng, m.js - 1, g);
    return t0 + m.fs * (at(t, neta, ng, m.js, g) - t0);
}

// Empirical minor-gas column adjustment; ref = chi_mls(gas, jp+1) unless a
// fixed reference is given (band 13's 3.55e-4).
__device__ __forceinline__ float adjcol(const Cell& c, int gas, float thresh,
                                        float base, float expo,
                                        float fixed_ref = -1.0f) {
    const float colgas = c.col(gas);
    const float coldry = c.f[COLDRY];
    const float ref = fixed_ref > 0.0f ? fixed_ref
                                       : c.chi[gas * NCHI + c.i[JP]];
    const float ratg = 1.0e20f * (colgas / coldry) / ref;
    const float adjfac = base + powf(fmaxf(ratg - base, 1e-12f), expo);
    const float adj = adjfac * ref * coldry * 1.0e-20f;
    return ratg > thresh ? adj : colgas;
}

template <int B, unsigned P>
struct Band {
    static constexpr int NG = ng_of(B);
    static constexpr int G0 = ngs_of(B);
    static constexpr int ROWS_A = 65 * nspa_of(B);
    static constexpr int ROWS_B = 235 * nspb_of(B);

    const Cell& c;
    __device__ explicit Band(const Cell& cell) : c(cell) {}

    __device__ float tauself(int g) const {
        if constexpr (!(P & CONT)) return 0.0f;
        return c.f[SELFFAC] * interp(c.self10, 10, NGPT, c.i[INDSELF],
                                     c.f[SELFFRAC], G0 + g);
    }
    __device__ float taufor(int g) const {
        if constexpr (!(P & CONT)) return 0.0f;
        return c.f[FORFAC] * interp(c.for4, 4, NGPT, c.i[INDFOR],
                                    c.f[FORFRAC], G0 + g);
    }
    __device__ float minor(int key, int g) const {
        if constexpr (!(P & MINOR)) return 0.0f;
        return interp(c.tab(key), 19, NG, c.i[INDMINOR], c.f[MINORFRAC], g);
    }
    __device__ float eminor(int key, int neta, const Spec& m, int g) const {
        if constexpr (!(P & MINOR)) return 0.0f;
        return eta_minor(c.tab(key), neta, NG, g, m, c.i[INDMINOR],
                         c.f[MINORFRAC]);
    }
    // halocarbon cross-section t (ccl4, cfc11adj, cfc12, cfc22adj) at g
    __device__ float halo(const float* t, int g) const {
        if constexpr (!(P & MINOR)) return 0.0f;
        return t[g];
    }
    // major1: one key species, (jp, jt) and (jp+1, jt1) rows
    __device__ float major1(int key, int rows, float colgas, int i0, int i1,
                            int g) const {
        if constexpr (!(P & MAJOR)) return 0.0f;
        const float* t = c.tab(key);
        return colgas * (c.f[FAC00] * at(t, rows, NG, i0, g)
                         + c.f[FAC10] * at(t, rows, NG, i0 + 1, g)
                         + c.f[FAC01] * at(t, rows, NG, i1, g)
                         + c.f[FAC11] * at(t, rows, NG, i1 + 1, g));
    }
    // Planck fraction: the fracref row t at g, or the eta-interpolated
    // value at m of a (neta, NG) fracref table t
    __device__ float frac(const float* t, int g) const {
        if constexpr (!(P & PLANCK)) return 0.0f;
        return t[g];
    }
    __device__ float planck(const float* t, int neta, const Spec& m,
                            int g) const {
        if constexpr (!(P & PLANCK)) return 0.0f;
        return planck_eta(t, neta, NG, g, m);
    }
    __device__ int i0_lower(int nsp) const {
        return ((c.i[JP] - 1) * 5 + (c.i[JT] - 1)) * nsp;
    }
    __device__ int i1_lower(int nsp) const {
        return (c.i[JP] * 5 + (c.i[JT1] - 1)) * nsp;
    }
    __device__ int i0_upper(int nsp) const {
        const int jp = c.i[JP] - 13;
        return ((jp > 0 ? jp : 0) * 5 + (c.i[JT] - 1)) * nsp;
    }
    __device__ int i1_upper(int nsp) const {
        const int jp = c.i[JP] - 12;
        return ((jp > 1 ? jp : 1) * 5 + (c.i[JT1] - 1)) * nsp;
    }
    // eta index/fraction of a pair at a fixed chi_mls level (1-based)
    __device__ Spec eta(int gas1, int gas2, int level, float mult) const {
        return spec(c.col(gas1), c.col(gas2),
                    c.ratio(gas1, gas2, level - 1), mult);
    }
};

// Lower 2-species major term at (jp, jt) and (jp+1, jt1).
template <int B, unsigned P>
struct Major2 {
    using Bd = Band<B, P>;
    Spec s0, s1;
    int i0, i1;
    __device__ Major2(const Bd& b, int gas1, int gas2) {
        const Cell& c = b.c;
        const int jp = c.i[JP];
        s0 = spec(c.col(gas1), c.col(gas2), c.ratio(gas1, gas2, jp - 1), 8.0f);
        s1 = spec(c.col(gas1), c.col(gas2), c.ratio(gas1, gas2, jp), 8.0f);
        i0 = b.i0_lower(9) + s0.js - 1;
        i1 = b.i1_lower(9) + s1.js - 1;
    }
    __device__ float operator()(const Bd& b, int g) const {
        if constexpr (!(P & MAJOR)) return 0.0f;
        const Cell& c = b.c;
        const float* a = c.tab(ABSA);
        return tau2sp(a, Bd::ROWS_A, Bd::NG, g, s0, i0, c.f[FAC00],
                      c.f[FAC10])
             + tau2sp(a, Bd::ROWS_A, Bd::NG, g, s1, i1, c.f[FAC01],
                      c.f[FAC11]);
    }
};

// Upper 2-species major term.
template <int B, unsigned P>
struct Major2Up {
    using Bd = Band<B, P>;
    Spec s0, s1;
    int i0, i1;
    __device__ Major2Up(const Bd& b, int gas1, int gas2) {
        const Cell& c = b.c;
        const int jp = c.i[JP];
        s0 = spec(c.col(gas1), c.col(gas2), c.ratio(gas1, gas2, jp - 1), 4.0f);
        s1 = spec(c.col(gas1), c.col(gas2), c.ratio(gas1, gas2, jp), 4.0f);
        i0 = b.i0_upper(5) + s0.js - 1;
        i1 = b.i1_upper(5) + s1.js - 1;
    }
    __device__ float operator()(const Bd& b, int g) const {
        if constexpr (!(P & MAJOR)) return 0.0f;
        const Cell& c = b.c;
        const float* t = c.tab(ABSB);
        return tau2sp_up(t, Bd::ROWS_B, Bd::NG, g, s0, i0, c.f[FAC00],
                         c.f[FAC10])
             + tau2sp_up(t, Bd::ROWS_B, Bd::NG, g, s1, i1, c.f[FAC01],
                         c.f[FAC11]);
    }
};

// b4 / b7 stratospheric per-g scale tweaks (rrtmg_lw_taumol.F90:948-954,
// :1323-1329)
__device__ __forceinline__ float b4_scale(int g) {
    switch (g) {
        case 7: return 0.92f; case 8: return 0.88f; case 9: return 1.07f;
        case 10: return 1.1f; case 11: return 0.99f; case 12: return 0.88f;
        case 13: return 0.943f; default: return 1.0f;
    }
}
__device__ __forceinline__ float b7_scale(int g) {
    switch (g) {
        case 5: return 0.92f; case 6: return 0.88f; case 7: return 1.07f;
        case 8: return 1.1f; case 9: return 0.99f; case 10: return 0.855f;
        default: return 1.0f;
    }
}

// Evaluate band B for one cell; tg/pf point at the band's first g-point.
template <int B, unsigned P>
__device__ void run_band(const Cell& c, float* tg, float* pf, float ta) {
    using Bd = Band<B, P>;
    const Bd b(c);
    constexpr int NG = Bd::NG;
    const bool lower = c.i[LOWER] != 0;
    const float* fa = c.tab(FRACA);
    const float* fb = c.tab(FRACB);

    if constexpr (B == 1 || B == 2) {
        if (lower) {
            const int i0 = b.i0_lower(1), i1 = b.i1_lower(1);
            const float scalen2 = c.f[COLBRD] * c.f[SCALEMINORN2];
            const float p = c.f[PAVEL];
            const float corr = B == 1
                ? (p < 250.0f ? 1.0f - 0.15f * (250.0f - p) / 154.4f : 1.0f)
                : 1.0f - 0.05f * (p - 100.0f) / 900.0f;
            for (int g = 0; g < NG; ++g) {
                float t = b.major1(ABSA, Bd::ROWS_A, c.f[COLH2O], i0, i1, g)
                        + b.tauself(g) + b.taufor(g);
                if (B == 1) t = t + scalen2 * b.minor(KA_MN2, g);
                tg[g] = corr * t + ta;
                pf[g] = b.frac(fa, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            const float scalen2 = c.f[COLBRD] * c.f[SCALEMINORN2];
            const float corr = 1.0f - 0.15f * (c.f[PAVEL] / 95.6f);
            for (int g = 0; g < NG; ++g) {
                float t = b.major1(ABSB, Bd::ROWS_B, c.f[COLH2O], u0, u1, g)
                        + b.taufor(g);
                if (B == 1) t = corr * (t + scalen2 * b.minor(KB_MN2, g));
                tg[g] = t + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 3) {
        const float adjn2o = adjcol(c, N2O, 1.5f, 0.5f, 0.65f);
        if (lower) {
            const Major2<B, P> m(b, H2O, CO2);
            const Spec mi = b.eta(H2O, CO2, 3, 8.0f);
            const Spec pl = b.eta(H2O, CO2, 9, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + adjn2o * b.eminor(KA_MN2O, 9, mi, g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            const Major2Up<B, P> m(b, H2O, CO2);
            const Spec mi = b.eta(H2O, CO2, 13, 4.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.taufor(g)
                      + adjn2o * b.eminor(KB_MN2O, 5, mi, g) + ta;
                pf[g] = b.planck(fb, 5, mi, g);
            }
        }
    } else if constexpr (B == 4) {
        if (lower) {
            const Major2<B, P> m(b, H2O, CO2);
            const Spec pl = b.eta(H2O, CO2, 11, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            const Major2Up<B, P> m(b, O3, CO2);
            const Spec pl = b.eta(O3, CO2, 13, 4.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) * b4_scale(g) + ta;
                pf[g] = b.planck(fb, 5, pl, g);
            }
        }
    } else if constexpr (B == 5) {
        const float* ccl4 = c.tab(CCL4);
        if (lower) {
            const Major2<B, P> m(b, H2O, CO2);
            const Spec mi = b.eta(H2O, CO2, 7, 8.0f);
            const Spec pl = b.eta(H2O, CO2, 5, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + c.f[COLO3] * b.eminor(KA_MO3, 9, mi, g)
                      + c.f[COLCCL4] * b.halo(ccl4, g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            const Major2Up<B, P> m(b, O3, CO2);
            const Spec pl = b.eta(O3, CO2, 43, 4.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + c.f[COLCCL4] * b.halo(ccl4, g) + ta;
                pf[g] = b.planck(fb, 5, pl, g);
            }
        }
    } else if constexpr (B == 6) {
        const float* cfc11 = c.tab(CFC11ADJ);
        const float* cfc12 = c.tab(CFC12);
        if (lower) {
            const int i0 = b.i0_lower(1), i1 = b.i1_lower(1);
            const float adjco2 = adjcol(c, CO2, 3.0f, 2.0f, 0.77f);
            for (int g = 0; g < NG; ++g) {
                const float cfc = c.f[COLCFC11] * b.halo(cfc11, g)
                                + c.f[COLCFC12] * b.halo(cfc12, g);
                tg[g] = b.major1(ABSA, Bd::ROWS_A, c.f[COLH2O], i0, i1, g)
                      + b.tauself(g) + b.taufor(g)
                      + adjco2 * b.minor(KA_MCO2, g) + cfc + ta;
                pf[g] = b.frac(fa, g);
            }
        } else {
            for (int g = 0; g < NG; ++g) {
                tg[g] = (c.f[COLCFC11] * b.halo(cfc11, g)
                         + c.f[COLCFC12] * b.halo(cfc12, g)) + ta;
                pf[g] = b.frac(fa, g);
            }
        }
    } else if constexpr (B == 7) {
        if (lower) {
            const Major2<B, P> m(b, H2O, O3);
            const Spec mi = b.eta(H2O, O3, 3, 8.0f);
            const float adjco2 = adjcol(c, CO2, 3.0f, 3.0f, 0.79f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + adjco2 * b.eminor(KA_MCO2, 9, mi, g) + ta;
                pf[g] = b.planck(fa, 9, mi, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            const float adjco2 = adjcol(c, CO2, 3.0f, 2.0f, 0.79f);
            for (int g = 0; g < NG; ++g) {
                const float t =
                    b.major1(ABSB, Bd::ROWS_B, c.f[COLO3], u0, u1, g)
                    + adjco2 * b.minor(KB_MCO2, g);
                tg[g] = t * b7_scale(g) + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 8) {
        const float adjco2 = adjcol(c, CO2, 3.0f, 2.0f, 0.65f);
        const float* cfc12 = c.tab(CFC12);
        const float* cfc22 = c.tab(CFC22ADJ);
        if (lower) {
            const int i0 = b.i0_lower(1), i1 = b.i1_lower(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSA, Bd::ROWS_A, c.f[COLH2O], i0, i1, g)
                      + b.tauself(g) + b.taufor(g)
                      + adjco2 * b.minor(KA_MCO2, g)
                      + c.f[COLO3] * b.minor(KA_MO3, g)
                      + c.f[COLN2O] * b.minor(KA_MN2O, g)
                      + c.f[COLCFC12] * b.halo(cfc12, g)
                      + c.f[COLCFC22] * b.halo(cfc22, g) + ta;
                pf[g] = b.frac(fa, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSB, Bd::ROWS_B, c.f[COLO3], u0, u1, g)
                      + adjco2 * b.minor(KB_MCO2, g)
                      + c.f[COLN2O] * b.minor(KB_MN2O, g)
                      + c.f[COLCFC12] * b.halo(cfc12, g)
                      + c.f[COLCFC22] * b.halo(cfc22, g) + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 9) {
        const float adjn2o = adjcol(c, N2O, 1.5f, 0.5f, 0.65f);
        if (lower) {
            const Major2<B, P> m(b, H2O, CH4);
            const Spec mi = b.eta(H2O, CH4, 3, 8.0f);
            const Spec pl = b.eta(H2O, CH4, 9, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + adjn2o * b.eminor(KA_MN2O, 9, mi, g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSB, Bd::ROWS_B, c.f[COLCH4], u0, u1, g)
                      + adjn2o * b.minor(KB_MN2O, g) + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 10 || B == 11) {
        const float scaleo2 = c.f[COLO2] * c.f[SCALEMINOR];
        if (lower) {
            const int i0 = b.i0_lower(1), i1 = b.i1_lower(1);
            for (int g = 0; g < NG; ++g) {
                float t = b.major1(ABSA, Bd::ROWS_A, c.f[COLH2O], i0, i1, g)
                        + b.tauself(g) + b.taufor(g);
                if (B == 11) t = t + scaleo2 * b.minor(KA_MO2, g);
                tg[g] = t + ta;
                pf[g] = b.frac(fa, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            for (int g = 0; g < NG; ++g) {
                float t = b.major1(ABSB, Bd::ROWS_B, c.f[COLH2O], u0, u1, g)
                        + b.taufor(g);
                if (B == 11) t = t + scaleo2 * b.minor(KB_MO2, g);
                tg[g] = t + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 12) {
        if (lower) {
            const Major2<B, P> m(b, H2O, CO2);
            const Spec pl = b.eta(H2O, CO2, 10, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            for (int g = 0; g < NG; ++g) {
                tg[g] = 0.0f + ta;
                pf[g] = 0.0f;
            }
        }
    } else if constexpr (B == 13) {
        if (lower) {
            const Major2<B, P> m(b, H2O, N2O);
            const Spec mc2 = b.eta(H2O, N2O, 1, 8.0f);
            const Spec mco = b.eta(H2O, N2O, 3, 8.0f);
            const Spec pl = b.eta(H2O, N2O, 5, 8.0f);
            const float adjco2 = adjcol(c, CO2, 3.0f, 2.0f, 0.68f, 3.55e-4f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + adjco2 * b.eminor(KA_MCO2, 9, mc2, g)
                      + c.f[COLCO] * b.eminor(KA_MCO, 9, mco, g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            for (int g = 0; g < NG; ++g) {
                tg[g] = c.f[COLO3] * b.minor(KB_MO3, g) + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 14) {
        if (lower) {
            const int i0 = b.i0_lower(1), i1 = b.i1_lower(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSA, Bd::ROWS_A, c.f[COLCO2], i0, i1, g)
                      + b.tauself(g) + b.taufor(g) + ta;
                pf[g] = b.frac(fa, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSB, Bd::ROWS_B, c.f[COLCO2], u0, u1, g)
                      + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    } else if constexpr (B == 15) {
        if (lower) {
            const Major2<B, P> m(b, N2O, CO2);
            const Spec mi = b.eta(N2O, CO2, 1, 8.0f);
            const float scalen2 = c.f[COLBRD] * c.f[SCALEMINOR];
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g)
                      + scalen2 * b.eminor(KA_MN2, 9, mi, g) + ta;
                pf[g] = b.planck(fa, 9, mi, g);
            }
        } else {
            for (int g = 0; g < NG; ++g) {
                tg[g] = 0.0f + ta;
                pf[g] = 0.0f;
            }
        }
    } else {  // band 16
        if (lower) {
            const Major2<B, P> m(b, H2O, CH4);
            const Spec pl = b.eta(H2O, CH4, 6, 8.0f);
            for (int g = 0; g < NG; ++g) {
                tg[g] = m(b, g) + b.tauself(g) + b.taufor(g) + ta;
                pf[g] = b.planck(fa, 9, pl, g);
            }
        } else {
            const int u0 = b.i0_upper(1), u1 = b.i1_upper(1);
            for (int g = 0; g < NG; ++g) {
                tg[g] = b.major1(ABSB, Bd::ROWS_B, c.f[COLCH4], u0, u1, g)
                      + ta;
                pf[g] = b.frac(fb, g);
            }
        }
    }
}

// Evaluate band `band` (1-based) of one cell; tg/pf point at the cell's
// rows of 140 g-points.
template <unsigned P>
__device__ void eval_band(int band, const Cell& c, float* tg, float* pf,
                          float ta) {
    switch (band) {
        case 1: run_band<1, P>(c, tg + ngs_of(1), pf + ngs_of(1), ta); break;
        case 2: run_band<2, P>(c, tg + ngs_of(2), pf + ngs_of(2), ta); break;
        case 3: run_band<3, P>(c, tg + ngs_of(3), pf + ngs_of(3), ta); break;
        case 4: run_band<4, P>(c, tg + ngs_of(4), pf + ngs_of(4), ta); break;
        case 5: run_band<5, P>(c, tg + ngs_of(5), pf + ngs_of(5), ta); break;
        case 6: run_band<6, P>(c, tg + ngs_of(6), pf + ngs_of(6), ta); break;
        case 7: run_band<7, P>(c, tg + ngs_of(7), pf + ngs_of(7), ta); break;
        case 8: run_band<8, P>(c, tg + ngs_of(8), pf + ngs_of(8), ta); break;
        case 9: run_band<9, P>(c, tg + ngs_of(9), pf + ngs_of(9), ta); break;
        case 10: run_band<10, P>(c, tg + ngs_of(10), pf + ngs_of(10), ta); break;
        case 11: run_band<11, P>(c, tg + ngs_of(11), pf + ngs_of(11), ta); break;
        case 12: run_band<12, P>(c, tg + ngs_of(12), pf + ngs_of(12), ta); break;
        case 13: run_band<13, P>(c, tg + ngs_of(13), pf + ngs_of(13), ta); break;
        case 14: run_band<14, P>(c, tg + ngs_of(14), pf + ngs_of(14), ta); break;
        case 15: run_band<15, P>(c, tg + ngs_of(15), pf + ngs_of(15), ta); break;
        default: run_band<16, P>(c, tg + ngs_of(16), pf + ngs_of(16), ta); break;
    }
}

// The kernel. The cells are [ncol][nlay]; one block takes a tile of TILE
// columns at one layer (lane = column), because cells at one layer of
// neighbouring columns share pressure and temperature indices and so read
// the same k-table rows: a warp's gather then touches a few cache lines
// where 32 layers of one column touch 32. Consecutive blocks take
// consecutive layers of the same columns. NWARP warps; warp w evaluates two
// bands one after the other, paired so that the warps' g-point counts are
// near equal (18, 18, 16, 16, 18, 20, 18, 16 of 140), and a warp never
// diverges over bands. The tile's 32 per-cell planes are loaded once into
// shared memory; every thread evaluates its (cell, band) into the tile's
// [TILE][ROW] rows of taug and pfracs in shared memory (ROW = 141: a row of
// 140 g-points padded by one float, so the 32 lanes of a warp writing one
// g-point land on 32 distinct banks); then the block writes each cell's
// two rows of 560 bytes as coalesced 16-byte stores (a row starts at a
// multiple of 16 bytes; the sectors it shares with the next layer's row are
// completed by the next block in L2). The last column group may hold fewer
// than TILE columns and is masked here. Two blocks fit an SM, so one
// block's loads and stores overlap the other's arithmetic.
constexpr int TILE = 32;
constexpr int NWARP = 8;
constexpr int BLOCK = NWARP * 32;
constexpr int ROW = NGPT + 1;
constexpr int NPLANE = NFF + NIF;         // 32 planes of one cell
constexpr int TA_ROW = NBND + 1;          // padded taua row of one cell

// band (1-based) of warp w's first (half 0) or second (half 1) pass
__device__ __forceinline__ int warp_band(int w, int half) {
    constexpr int A[NWARP] = {3, 5, 4, 2, 7, 9, 1, 11};
    constexpr int B[NWARP] = {14, 15, 16, 13, 10, 6, 8, 12};
    return half == 0 ? A[w] : B[w];
}

template <unsigned P>
__global__ void __launch_bounds__(BLOCK, 2)
taumol_lw_kernel(const float* __restrict__ fplanes,
                 const int* __restrict__ iplanes,
                 const float* __restrict__ pack,
                 const int* __restrict__ offsets,
                 const float* __restrict__ taua,
                 float* __restrict__ taug, float* __restrict__ pfracs,
                 int ncol, int nlay) {
    __shared__ __align__(16) float s_tg[TILE * ROW];
    __shared__ __align__(16) float s_pf[TILE * ROW];
    // the tile's planes, [TILE][NFF] and [TILE][NIF]: a lane's fields are
    // contiguous, and lanes reading one field hit distinct banks (NFF and
    // NIF are odd)
    __shared__ float s_f[TILE * NFF];
    __shared__ int s_i[TILE * NIF];
    __shared__ float s_ta[TILE * TA_ROW];

    const int t = threadIdx.x;
    const int lane = t % 32;
    const int warp = t / 32;
    const int lay = blockIdx.x % nlay;
    const int col0 = blockIdx.x / nlay * TILE;
    const int n = ncol - col0 < TILE ? ncol - col0 : TILE;
    const size_t ncells = static_cast<size_t>(ncol) * nlay;
    // the tile's cell c is (col0 + c, lay)
    auto cell = [&](int c) {
        return static_cast<size_t>(col0 + c) * nlay + lay;
    };

    for (int e = t; e < NPLANE * TILE; e += BLOCK) {
        const int k = e / TILE, c = e % TILE;
        if (c < n) {
            if (k < NFF)
                s_f[c * NFF + k] = fplanes[k * ncells + cell(c)];
            else
                s_i[c * NIF + k - NFF] = iplanes[(k - NFF) * ncells + cell(c)];
        }
    }
    if (taua != nullptr) {
        for (int e = t; e < TILE * NBND; e += BLOCK) {
            const int c = e / NBND, b = e % NBND;
            if (c < n) s_ta[c * TA_ROW + b] = taua[cell(c) * NBND + b];
        }
    }
    __syncthreads();

    if (lane < n) {
        Cell c;
        c.f = s_f + lane * NFF;
        c.i = s_i + lane * NIF;
        c.P = pack;
        c.chi = pack + offsets[16 * NKEY];
        c.self10 = pack + offsets[16 * NKEY + 1];
        c.for4 = pack + offsets[16 * NKEY + 2];
        float* tg = s_tg + lane * ROW;
        float* pf = s_pf + lane * ROW;
        for (int half = 0; half < 2; ++half) {
            const int band = warp_band(warp, half);
            c.ob = offsets + (band - 1) * NKEY;
            const float ta = taua ? s_ta[lane * TA_ROW + band - 1] : 0.0f;
            eval_band<P>(band, c, tg, pf, ta);
        }
    }
    __syncthreads();

    // each cell's row is 140 floats, 35 float4s: thread t stores float4s
    // t, t + BLOCK, ... of the tile's n rows
    for (int q = t; q < n * (NGPT / 4); q += BLOCK) {
        const int c = q / (NGPT / 4), v = q % (NGPT / 4);
        const int j = c * ROW + 4 * v;
        const size_t o = cell(c) * NGPT + 4 * v;
        *reinterpret_cast<float4*>(taug + o) =
            make_float4(s_tg[j], s_tg[j + 1], s_tg[j + 2], s_tg[j + 3]);
        *reinterpret_cast<float4*>(pfracs + o) =
            make_float4(s_pf[j], s_pf[j + 1], s_pf[j + 2], s_pf[j + 3]);
    }
}

// Launch the kernel of parts P over the [ncol][nlay] cells (taua may be
// null).
template <unsigned P>
int launch_taumol_lw(const float* fplanes, const int* iplanes,
                     const float* pack, const int* offsets, const float* taua,
                     float* taug, float* pfracs, int ncol, int nlay,
                     int noffsets, void* stream) {
    if (ncol <= 0 || nlay <= 0 || noffsets != NOFFSETS)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((ncol + TILE - 1) / TILE * nlay);
    taumol_lw_kernel<P><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        fplanes, iplanes, pack, offsets, taua, taug, pfracs, ncol, nlay);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
