// K5: RRTMG-SW gas and Rayleigh optical depths (taumol_sw).
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/models/rrtmg/
// taumol_sw_pallas.py:taumol_sw_pallas and computes what the CPU oracle
// computes (models/rrtmg/taumol_sw.py, to the per-band spec taumol_sw_ref)
// for the 14 bands 16..29: one- or two-species key absorption with the
// plain two-point eta interpolation (mult 8 and 9 eta points below ~96 hPa,
// mult 4 and 5 above), the water self and foreign continua, the gray CH4,
// O3, CO2, H2O and O2 terms, and the Rayleigh depth (per g or scalar; band
// 24's lower one eta-interpolated). The TPU kernel's bf16x3 table splits are
// TPU-only: this kernel reads the float32 tables. The solar source stays in
// plain PyTorch (models/rrtmg/taumol_sw.py:sfluxzen_only), as in the TPU
// wrapper.
//
// Bound on the H100: table gathers (up to 8 per (cell, g-point) from ~0.5 MB
// of k-tables that stay in L2), and writing taug and taur (530 MB at
// 8192 x 72 x 112). Design: one thread per (cell, band), blockIdx.y = band,
// so a warp never diverges over bands; the thread evaluates its cell's
// lower- or upper-atmosphere formula once (eta indices and weights) and
// loops over the band's g-points. The k-tables are one packed float32
// vector; a per-band row says where each table starts (-1 if absent) and a
// second one how many rows it has.

#include "common.cuh"

namespace {

using namespace geosrad;

constexpr float ONEMINUS = static_cast<float>(1.0 - 1.0e-6);
constexpr int BLOCK = 128;

// per-band table slots (BAND_KEYS in models/rrtmg/taumol_sw.py)
enum Key {
    ABSA, ABSB, SELFREF, FORREF, RAYL, RAYLA, RAYLB, ABSCH4, ABSO3A, ABSO3B,
    ABSCO2, ABSH2O, NKEY
};
// per-cell float planes (FLOAT_FIELDS in models/rrtmg/taumol_sw_cuda.py)
enum FField {
    FAC00, FAC01, FAC10, FAC11, SELFFAC, SELFFRAC, FORFAC, FORFRAC, COLH2O,
    COLCO2, COLO3, COLCH4, COLO2, COLMOL, NFF
};
// per-cell int planes (INT_FIELDS)
enum IField { LOWER, JP, JT, JT1, INDSELF, INDFOR, NIF };

// key-species ratios strrat (rrtmg_sw_taumol.F90), as the reference's
// Python floats rounded to float32
constexpr float STRRAT16 = 252.131f, STRRAT17 = 0.364641f,
                STRRAT18 = 38.9589f, STRRAT19 = 5.49281f,
                STRRAT21 = 0.0045321f,
                STRRAT22 = static_cast<float>(1.6 * 0.022708),
                STRRAT24 = 0.124692f, STRRAT28 = 6.67029e-07f;

// eta points of the lower / upper key tables (rrtmg_sw_init.F90:198-199)
__host__ __device__ constexpr int nspa_sw(int bi) {
    return (bi == 4 || bi == 7 || bi == 9 || bi == 11 || bi == 13) ? 1
         : bi == 10 ? 0 : 9;
}
__host__ __device__ constexpr int nspb_sw(int bi) {
    return (bi == 1 || bi == 5 || bi == 12) ? 5
         : (bi == 7 || bi == 9 || bi == 10) ? 0 : 1;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

struct Eta {
    float sc;   // speccomb
    float fs;
    int js;     // 1-based eta index
};

__device__ __forceinline__ Eta eta(float c1, float c2, float strrat,
                                   float mult) {
    Eta e;
    e.sc = c1 + strrat * c2;
    const float sp = fminf(c1 / e.sc, ONEMINUS);
    const float sm = mult * sp;
    const float fl = floorf(sm);
    e.js = 1 + static_cast<int>(fl);
    e.fs = sm - fl;
    return e;
}

struct Cell {
    float f[NFF];
    int i[NIF];
    const float* P;      // packed tables
    const int* ob;       // this band's table offsets [NKEY]
    const int* rows;     // this band's table row counts [NKEY]
    int ng;

    // element (row r clamped to the table, column g) of table key
    __device__ float at(int key, int r, int g) const {
        return P[ob[key] + clampi(r, 0, rows[key] - 1) * ng + g];
    }
    // t[ind-1] + frac * (t[ind] - t[ind-1]), ind 1-based
    __device__ float interp(int key, int ind, float frac, int g) const {
        const float t0 = at(key, ind - 1, g);
        return t0 + frac * (at(key, ind, g) - t0);
    }
    // fac-weighted sum of the rows ind0, ind0+1, ind1, ind1+1
    __device__ float sum4(int key, int ind0, int ind1, int g) const {
        return f[FAC00] * at(key, ind0, g) + f[FAC10] * at(key, ind0 + 1, g)
             + f[FAC01] * at(key, ind1, g) + f[FAC11] * at(key, ind1 + 1, g);
    }
    // two-species key tau at (jp, jt) and (jp+1, jt1), eta shared
    __device__ float major2(int key, const Eta& e, int base0, int base1,
                            int estride, int g) const {
        const int a = base0 + e.js - 1;
        const int b = base1 + e.js - 1;
        const float w0 = 1.0f - e.fs;
        return e.sc * (w0 * f[FAC00] * at(key, a, g)
                       + e.fs * f[FAC00] * at(key, a + 1, g)
                       + w0 * f[FAC10] * at(key, a + estride, g)
                       + e.fs * f[FAC10] * at(key, a + estride + 1, g)
                       + w0 * f[FAC01] * at(key, b, g)
                       + e.fs * f[FAC01] * at(key, b + 1, g)
                       + w0 * f[FAC11] * at(key, b + estride, g)
                       + e.fs * f[FAC11] * at(key, b + estride + 1, g));
    }
    // foreign continuum, plus the self continuum when include_self
    __device__ float selffor(bool include_self, int g) const {
        float out = f[FORFAC] * interp(FORREF, i[INDFOR], f[FORFRAC], g);
        if (include_self)
            out = out + f[SELFFAC] * interp(SELFREF, i[INDSELF],
                                            f[SELFFRAC], g);
        return out;
    }
};

__global__ void __launch_bounds__(BLOCK)
taumol_sw_kernel(const float* __restrict__ fplanes,
                 const int* __restrict__ iplanes,
                 const float* __restrict__ pack,
                 const int* __restrict__ offsets,
                 float* __restrict__ taug, float* __restrict__ taur,
                 int ncells) {
    const int cell = blockIdx.x * BLOCK + threadIdx.x;
    const int bi = blockIdx.y;               // 0..13 = band 16..29
    if (cell >= ncells) return;
    Cell c;
    for (int k = 0; k < NFF; ++k)
        c.f[k] = fplanes[static_cast<size_t>(k) * ncells + cell];
    for (int k = 0; k < NIF; ++k)
        c.i[k] = iplanes[static_cast<size_t>(k) * ncells + cell];
    c.P = pack;
    c.ob = offsets + bi * NKEY;
    c.rows = offsets + NBND_SW * NKEY + bi * NKEY;
    c.ng = ng_sw(bi);

    const bool lower = c.i[LOWER] != 0;
    const int jp = c.i[JP], jt = c.i[JT], jt1 = c.i[JT1];
    const int nspa = nspa_sw(bi), nspb = nspb_sw(bi);
    const int i0b = ((jp - 1) * 5 + (jt - 1)) * nspa;
    const int i1b = (jp * 5 + (jt1 - 1)) * nspa;
    const int u0b = ((jp - 13 > 0 ? jp - 13 : 0) * 5 + (jt - 1)) * nspb;
    const int u1b = ((jp - 12 > 1 ? jp - 12 : 1) * 5 + (jt1 - 1)) * nspb;
    const float h2o = c.f[COLH2O], co2 = c.f[COLCO2], o3 = c.f[COLO3],
                ch4 = c.f[COLCH4], o2 = c.f[COLO2], colmol = c.f[COLMOL];
    const int band = bi + 16;

    // eta weights of the two-species bands, for this cell's regime
    Eta e{0.0f, 0.0f, 1};
    switch (band) {
        case 16: if (lower) e = eta(h2o, ch4, STRRAT16, 8.0f); break;
        case 17: e = eta(h2o, co2, STRRAT17, lower ? 8.0f : 4.0f); break;
        case 18: if (lower) e = eta(h2o, ch4, STRRAT18, 8.0f); break;
        case 19: if (lower) e = eta(h2o, co2, STRRAT19, 8.0f); break;
        case 21: e = eta(h2o, co2, STRRAT21, lower ? 8.0f : 4.0f); break;
        case 22: if (lower) e = eta(h2o, o2, STRRAT22, 8.0f); break;
        case 24: if (lower) e = eta(h2o, o2, STRRAT24, 8.0f); break;
        case 28: e = eta(o3, o2, STRRAT28, lower ? 8.0f : 4.0f); break;
        default: break;
    }
    const float o2cont = 4.35e-4f * o2 / 700.0f;

    float* tg = taug + static_cast<size_t>(cell) * NGPT_SW + ngs_sw(bi);
    float* tr = taur + static_cast<size_t>(cell) * NGPT_SW + ngs_sw(bi);
    for (int g = 0; g < c.ng; ++g) {
        float t = 0.0f;
        if (lower) {
            switch (band) {
                case 16: case 17: case 18: case 19: case 21:
                    t = c.major2(ABSA, e, i0b, i1b, 9, g)
                        + h2o * c.selffor(true, g);
                    break;
                case 20:
                    t = h2o * (c.sum4(ABSA, i0b, i1b, g) + c.selffor(true, g))
                        + ch4 * c.at(ABSCH4, 0, g);
                    break;
                case 22:
                    t = c.major2(ABSA, e, i0b, i1b, 9, g)
                        + h2o * c.selffor(true, g) + o2cont;
                    break;
                case 23:
                    t = h2o * (1.029f * c.sum4(ABSA, i0b, i1b, g)
                               + c.selffor(true, g));
                    break;
                case 24:
                    t = c.major2(ABSA, e, i0b, i1b, 9, g)
                        + h2o * c.selffor(true, g) + o3 * c.at(ABSO3A, 0, g);
                    break;
                case 25:
                    t = h2o * c.sum4(ABSA, i0b, i1b, g)
                        + o3 * c.at(ABSO3A, 0, g);
                    break;
                case 27: t = o3 * c.sum4(ABSA, i0b, i1b, g); break;
                case 28: t = c.major2(ABSA, e, i0b, i1b, 9, g); break;
                case 29:
                    t = h2o * (c.sum4(ABSA, i0b, i1b, g) + c.selffor(true, g))
                        + co2 * c.at(ABSCO2, 0, g);
                    break;
                default: break;                       // band 26
            }
        } else {
            switch (band) {
                case 16: case 18: t = ch4 * c.sum4(ABSB, u0b, u1b, g); break;
                case 17: case 21:
                    t = c.major2(ABSB, e, u0b, u1b, 5, g)
                        + h2o * c.selffor(false, g);
                    break;
                case 19: t = co2 * c.sum4(ABSB, u0b, u1b, g); break;
                case 20:
                    t = h2o * (c.sum4(ABSB, u0b, u1b, g) + c.selffor(false, g))
                        + ch4 * c.at(ABSCH4, 0, g);
                    break;
                case 22:
                    t = o2 * 1.6f * c.sum4(ABSB, u0b, u1b, g) + o2cont;
                    break;
                case 24:
                    t = o2 * c.sum4(ABSB, u0b, u1b, g)
                        + o3 * c.at(ABSO3B, 0, g);
                    break;
                case 25: t = o3 * c.at(ABSO3B, 0, g); break;
                case 27: t = o3 * c.sum4(ABSB, u0b, u1b, g); break;
                case 28: t = c.major2(ABSB, e, u0b, u1b, 5, g); break;
                case 29:
                    t = co2 * c.sum4(ABSB, u0b, u1b, g)
                        + h2o * c.at(ABSH2O, 0, g);
                    break;
                default: break;                       // bands 23 and 26
            }
        }
        tg[g] = t;
        if (band != 24) {
            tr[g] = colmol * c.at(RAYL, 0, g);
        } else if (lower) {
            const float t0 = c.at(RAYLA, e.js - 1, g);
            tr[g] = colmol * (t0 + e.fs * (c.at(RAYLA, e.js, g) - t0));
        } else {
            tr[g] = colmol * c.at(RAYLB, 0, g);
        }
    }
}

}  // namespace

extern "C" int taumol_sw(const float* fplanes, const int* iplanes,
                         const float* pack, const int* offsets, float* taug,
                         float* taur, int ncells, int noffsets,
                         void* stream) {
    if (ncells <= 0 || noffsets != 2 * NBND_SW * NKEY)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((ncells + BLOCK - 1) / BLOCK, NBND_SW);
    taumol_sw_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        fplanes, iplanes, pack, offsets, taug, taur, ncells);
    return static_cast<int>(cudaGetLastError());
}
