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
// Bound on the H100: writing taug and taur (2 x 448 B per cell, 248 MB at
// 3840 x 72) and the table gathers (4 to 8 rows per (cell, g-point) from
// ~0.4 MB of k-tables). Design (K3's, csrc/taumol_lw.cuh): one block takes
// a tile of TILE columns at one layer, lane = column, because cells at one
// layer of neighbouring columns share pressure and temperature indices and
// so gather the same table rows; consecutive blocks take consecutive layers
// of the same columns. The warps take the 14 bands, one or two each, paired
// so that their gathers are near equal (warp_band), and a warp never
// diverges over bands. The tile's 20 per-cell fields are read once, in
// place (the wrapper passes a pointer per field, by value), into shared
// memory (the 32 columns of a tile lie nlay cells apart, so a warp's load
// of one field touches 32 sectors; the blocks of the neighbouring layers
// use the rest of them from L2); each thread evaluates its (cell, band) into the tile's rows of
// taug and taur in shared memory (ROW = 113: a row of 112 g-points padded by
// one float, so the 32 lanes writing one g-point land on 32 distinct banks);
// then the block writes each cell's two rows of 448 bytes (whole 32-byte
// sectors) as coalesced 16-byte stores. Four blocks fit an SM (at most 64
// registers a thread, 31 KB of shared memory a block). The k-tables are
// one packed float32 vector; a per-band row says where each table starts
// (-1 if absent) and a second one how many rows it has.

#include "common.cuh"

namespace {

using namespace geosrad;

constexpr float ONEMINUS = static_cast<float>(1.0 - 1.0e-6);
constexpr int TILE = 32;
constexpr int NWARP = 8;
constexpr int BLOCK = NWARP * 32;
constexpr int ROW = NGPT_SW + 1;

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
// per-cell int fields (INT_FIELDS)
enum IField { LOWER, JP, JT, JT1, INDSELF, INDFOR, NIF };
// a cell's fields in shared memory, at odd strides so that the lanes
// reading one field hit distinct banks
constexpr int FSTRIDE = NFF + 1;
constexpr int ISTRIDE = NIF + 1;

// The cells' fields as the wrapper hands them over, in the order of
// FLOAT_FIELDS + INT_FIELDS: float32, then `lower` as bool bytes, then
// int32.
struct Fields {
    const float* f[NFF];
    const unsigned char* lower;
    const int* i[NIF - 1];   // JP .. INDFOR
};

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
    const float* f;      // the cell's fields in shared memory
    const int* i;
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

// Band BI (0-based, band 16 + BI) of one cell, into its rows tg, tr of
// the band's g-points.
template <int BI>
__device__ void run_band(const Cell& c, float* tg, float* tr) {
    constexpr int band = BI + 16;
    constexpr int nspa = nspa_sw(BI), nspb = nspb_sw(BI);
    const bool lower = c.i[LOWER] != 0;
    const int jp = c.i[JP], jt = c.i[JT], jt1 = c.i[JT1];
    const int i0b = ((jp - 1) * 5 + (jt - 1)) * nspa;
    const int i1b = (jp * 5 + (jt1 - 1)) * nspa;
    const int u0b = ((jp - 13 > 0 ? jp - 13 : 0) * 5 + (jt - 1)) * nspb;
    const int u1b = ((jp - 12 > 1 ? jp - 12 : 1) * 5 + (jt1 - 1)) * nspb;
    const float h2o = c.f[COLH2O], co2 = c.f[COLCO2], o3 = c.f[COLO3],
                ch4 = c.f[COLCH4], o2 = c.f[COLO2], colmol = c.f[COLMOL];

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

__device__ void eval_band(int bi, const Cell& c, float* tg, float* tr) {
    switch (bi) {
        case 0: run_band<0>(c, tg, tr); break;
        case 1: run_band<1>(c, tg, tr); break;
        case 2: run_band<2>(c, tg, tr); break;
        case 3: run_band<3>(c, tg, tr); break;
        case 4: run_band<4>(c, tg, tr); break;
        case 5: run_band<5>(c, tg, tr); break;
        case 6: run_band<6>(c, tg, tr); break;
        case 7: run_band<7>(c, tg, tr); break;
        case 8: run_band<8>(c, tg, tr); break;
        case 9: run_band<9>(c, tg, tr); break;
        case 10: run_band<10>(c, tg, tr); break;
        case 11: run_band<11>(c, tg, tr); break;
        case 12: run_band<12>(c, tg, tr); break;
        default: run_band<13>(c, tg, tr); break;
    }
}

// Band (0-based, -1 for none) of warp w's first (half 0) or second (half 1)
// pass. Gathers per cell of each band in the lower atmosphere, g-points x
// rows per g-point (8 for a two-species key, 4 for one, 2 per continuum, 1
// per gray term and Rayleigh): 16: 78, 17: 156, 18: 104, 19: 104, 20: 100,
// 21: 130, 22: 26, 23: 90, 24: 120, 25: 36, 26: 6, 27: 40, 28: 54, 29: 120;
// the pairs take 156, 130, 146, 126, 144, 140, 154 and 168 of 1,164.
__device__ __forceinline__ int warp_band(int w, int half) {
    constexpr int A[NWARP] = {1, 5, 8, 13, 2, 3, 4, 7};
    constexpr int B[NWARP] = {-1, -1, 6, 10, 11, 9, 12, 0};
    return half == 0 ? A[w] : B[w];
}

__global__ void __launch_bounds__(BLOCK, 4)
taumol_sw_kernel(Fields in, const float* __restrict__ pack,
                 const int* __restrict__ offsets,
                 float* __restrict__ taug, float* __restrict__ taur,
                 int ncol, int nlay) {
    __shared__ __align__(16) float s_tg[TILE * ROW];
    __shared__ __align__(16) float s_tr[TILE * ROW];
    __shared__ float s_f[TILE * FSTRIDE];
    __shared__ int s_i[TILE * ISTRIDE];

    const int t = threadIdx.x;
    const int lane = t % 32;
    const int warp = t / 32;
    const int lay = blockIdx.x % nlay;
    const int col0 = blockIdx.x / nlay * TILE;
    const int n = ncol - col0 < TILE ? ncol - col0 : TILE;
    // the tile's cell c is (col0 + c, lay)
    auto cell = [&](int c) {
        return static_cast<size_t>(col0 + c) * nlay + lay;
    };

    for (int e = t; e < (NFF + NIF) * TILE; e += BLOCK) {
        const int k = e / TILE, c = e % TILE;
        if (c < n) {
            const size_t x = cell(c);
            if (k < NFF)
                s_f[c * FSTRIDE + k] = in.f[k][x];
            else if (k == NFF)
                s_i[c * ISTRIDE + LOWER] = in.lower[x];
            else
                s_i[c * ISTRIDE + k - NFF] = in.i[k - NFF - 1][x];
        }
    }
    __syncthreads();

    if (lane < n) {
        Cell c;
        c.f = s_f + lane * FSTRIDE;
        c.i = s_i + lane * ISTRIDE;
        c.P = pack;
        for (int half = 0; half < 2; ++half) {
            const int bi = warp_band(warp, half);
            if (bi < 0) continue;
            c.ob = offsets + bi * NKEY;
            c.rows = offsets + NBND_SW * NKEY + bi * NKEY;
            c.ng = ng_sw(bi);
            eval_band(bi, c, s_tg + lane * ROW + ngs_sw(bi),
                      s_tr + lane * ROW + ngs_sw(bi));
        }
    }
    __syncthreads();

    // each cell's row is 112 floats, 28 float4s: thread t stores float4s
    // t, t + BLOCK, ... of the tile's n rows
    for (int q = t; q < n * (NGPT_SW / 4); q += BLOCK) {
        const int c = q / (NGPT_SW / 4), v = q % (NGPT_SW / 4);
        const int j = c * ROW + 4 * v;
        const size_t o = cell(c) * NGPT_SW + 4 * v;
        *reinterpret_cast<float4*>(taug + o) =
            make_float4(s_tg[j], s_tg[j + 1], s_tg[j + 2], s_tg[j + 3]);
        *reinterpret_cast<float4*>(taur + o) =
            make_float4(s_tr[j], s_tr[j + 1], s_tr[j + 2], s_tr[j + 3]);
    }
}

}  // namespace

// fields: a host array of the NFF + NIF field pointers (device memory), in
// the order of Fields.
extern "C" int taumol_sw(const void* const* fields, const float* pack,
                         const int* offsets, float* taug, float* taur,
                         int nfields, int ncol, int nlay, int noffsets,
                         void* stream) {
    if (nfields != NFF + NIF || ncol <= 0 || nlay <= 0
        || noffsets != 2 * NBND_SW * NKEY)
        return static_cast<int>(cudaErrorInvalidValue);
    Fields in;
    for (int k = 0; k < NFF; ++k)
        in.f[k] = static_cast<const float*>(fields[k]);
    in.lower = static_cast<const unsigned char*>(fields[NFF]);
    for (int k = 0; k < NIF - 1; ++k)
        in.i[k] = static_cast<const int*>(fields[NFF + 1 + k]);
    const dim3 grid((ncol + TILE - 1) / TILE * nlay);
    taumol_sw_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        in, pack, offsets, taug, taur, ncol, nlay);
    return static_cast<int>(cudaGetLastError());
}
