// K9: the LW table rows, the linear interpolations in the rows of 16
// floats (one per LW band) of the small LW tables.
//
// Computes what models/rrtmg/cldprmc_lw.py:band_abs_coeffs_lw (the cloud
// rows) and models/rrtmg/setcoef_lw.py:planck_rows_plain (the Planck rows),
// its plain twins, compute, bit for bit. One template, two launches per
// LW solve:
//  * cloud (KIND CLOUD, or LIQ where the iceflag has no row table): absice
//    from the ice table at (reice - 2) / 3 and absliq from absliq1 at
//    reliq - 1.5;
//  * Planck (KIND PLANCK): planklay at tavel, planklev at tz, and at
//    tbound plankbnd = semiss * row of totplnk and, where asked,
//    dplankbnd = semiss * row of totplnkderiv, each at t - 159.
// Each row: index = clamp(floor(factor), 1, rows - 1), fint = factor -
// index, out = lo + fint * (hi - lo) with lo, hi the rows index - 1 and
// index (1-based index, so 0-based rows), every operation rounded as the
// twin's separate PyTorch passes round it (_rn intrinsics, so that nvcc
// contracts no FMA). The ice factor's division by 3 is rounded as
// PyTorch rounds the twin's on a CUDA tensor: a product with the float
// reciprocal of 3 (ATen's div_true_kernel_cuda with a scalar divisor).
//
// Bound on the H100: the bytes, one input float per point (plus semiss
// at the surface) and 64 B written per point; the tables (<= 181 x 16
// floats each) are read from L1. Design, after P2's gather_rows
// (gather_micro.cu): a point's row is 4 float4; a block of 4 x 64
// threads holds 64 points at a time, so a warp's 16-byte stores cover 512
// contiguous bytes; each thread takes ITEMS points a block height apart
// and issues their input loads, then their table loads, then their
// streaming stores (__stcs: the outputs are read by later kernels, not
// by this one), so several loads are in flight. The tables stay where
// they are and are read through the read-only path (__ldg). A launch
// covers up to three segments of points (ice and liquid; layers, levels
// and the surface), each a run of whole blocks, so a block never
// branches on its segment. Index arithmetic is 32-bit (the wrapper keeps
// 4 x points below 2^31); only addresses widen.

#include "common.cuh"

namespace {

constexpr int VEC = 4;               // float4 per row of 16 floats
constexpr int BY = 64;               // points per block row
constexpr int THREADS = VEC * BY;
constexpr int ITEMS = 4;             // points per thread, BY apart
constexpr int PER_BLOCK = BY * ITEMS;
constexpr int MAX_POINTS = 0x7fffffff / VEC - PER_BLOCK;

enum Kind { CLOUD = 0, LIQ = 1, PLANCK = 2 };

struct Seg {
    const float* x;       // per point: radius (um) or temperature (K)
    const float4* tab;    // [rows][VEC]
    float4* out;          // [n][VEC]
    int n;                // points
    int rows;             // table rows
    int end;              // one past the segment's last block
    float off;            // factor = x - off (then / 3 for the ice)
};

struct Rows {
    Seg seg[3];
    // the surface segment of PLANCK: semiss [n][VEC] scales its rows, and
    // dtab / dout, where not null, give dplankbnd at the same rows
    const float4* semiss;
    const float4* dtab;
    float4* dout;
};

__device__ __forceinline__ float4 lerp4(float4 lo, float4 hi, float f) {
    return make_float4(
        __fadd_rn(lo.x, __fmul_rn(f, __fsub_rn(hi.x, lo.x))),
        __fadd_rn(lo.y, __fmul_rn(f, __fsub_rn(hi.y, lo.y))),
        __fadd_rn(lo.z, __fmul_rn(f, __fsub_rn(hi.z, lo.z))),
        __fadd_rn(lo.w, __fmul_rn(f, __fsub_rn(hi.w, lo.w))));
}

__device__ __forceinline__ float4 scale4(float4 s, float4 v) {
    return make_float4(__fmul_rn(s.x, v.x), __fmul_rn(s.y, v.y),
                       __fmul_rn(s.z, v.z), __fmul_rn(s.w, v.w));
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
lw_rows_kernel(const Rows a) {
    const int b = blockIdx.x;
    const int s = b < a.seg[0].end ? 0 : (b < a.seg[1].end ? 1 : 2);
    // selected field by field: an array of kernel parameters indexed at
    // run time would be copied to local memory
    const Seg g = s == 0 ? a.seg[0] : (s == 1 ? a.seg[1] : a.seg[2]);
    const int first = s == 0 ? 0 : (s == 1 ? a.seg[0].end : a.seg[1].end);
    const int p0 = (b - first) * PER_BLOCK + threadIdx.y;
    const int q = threadIdx.x;
    const bool ice = KIND == CLOUD && s == 0;
    const bool surface = KIND == PLANCK && s == 2;

    int row[ITEMS];
    float fint[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int p = p0 + i * BY;
        float f = __fsub_rn(p < g.n ? __ldg(g.x + p) : g.off, g.off);
        if (ice) f = __fmul_rn(f, 1.0f / 3.0f);
        const float fl = fminf(fmaxf(floorf(f), 1.0f),
                               static_cast<float>(g.rows - 1));
        fint[i] = __fsub_rn(f, fl);
        row[i] = static_cast<int>(fl);
    }
    float4 lo[ITEMS], hi[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        lo[i] = __ldg(g.tab + (row[i] - 1) * VEC + q);
        hi[i] = __ldg(g.tab + row[i] * VEC + q);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int p = p0 + i * BY;
        if (p >= g.n) break;
        const int o = p * VEC + q;
        float4 v = lerp4(lo[i], hi[i], fint[i]);
        if (surface) {
            const float4 e = __ldg(a.semiss + o);
            v = scale4(e, v);
            if (a.dout != nullptr) {
                const float4 dl = __ldg(a.dtab + (row[i] - 1) * VEC + q);
                const float4 dh = __ldg(a.dtab + row[i] * VEC + q);
                __stcs(a.dout + o, scale4(e, lerp4(dl, dh, fint[i])));
            }
        }
        __stcs(g.out + o, v);
    }
}

Seg segment(const float* x, const float* tab, float* out, int n, int rows,
            float off, int* blocks) {
    *blocks += (n + PER_BLOCK - 1) / PER_BLOCK;
    return Seg{x, reinterpret_cast<const float4*>(tab),
               reinterpret_cast<float4*>(out), n, rows, *blocks, off};
}

bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % sizeof(float4) == 0;
}

template <int KIND>
int launch(const Rows& a, int blocks, void* stream) {
    if (blocks > 0)
        lw_rows_kernel<KIND><<<blocks, dim3(VEC, BY), 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cloud rows of n cells: absice (unless reice is null, iceflags 0 and
// 1) from ice_tab [nice][16] and absliq from liq_tab [nliq][16], each
// [n][16]. Tables and outputs 16-byte aligned.
extern "C" int lw_rows_cloud(const float* reice, const float* reliq,
                             const float* ice_tab, const float* liq_tab,
                             float* absice, float* absliq, int n, int nice,
                             int nliq, void* stream) {
    const bool with_ice = reice != nullptr;
    if (n < 0 || n > MAX_POINTS || nliq < 2 || (with_ice && nice < 2)
        || !aligned(liq_tab) || !aligned(absliq)
        || (with_ice && (!aligned(ice_tab) || !aligned(absice))))
        return static_cast<int>(cudaErrorInvalidValue);
    Rows a{};
    int blocks = 0;
    if (with_ice) {
        a.seg[0] = segment(reice, ice_tab, absice, n, nice, 2.0f, &blocks);
        a.seg[1] = segment(reliq, liq_tab, absliq, n, nliq, 1.5f, &blocks);
        a.seg[2] = a.seg[1];
        return launch<CLOUD>(a, blocks, stream);
    }
    a.seg[0] = segment(reliq, liq_tab, absliq, n, nliq, 1.5f, &blocks);
    a.seg[1] = a.seg[2] = a.seg[0];
    return launch<LIQ>(a, blocks, stream);
}

// The Planck rows: planklay [nlay_pts][16] at tavel, planklev
// [nlev_pts][16] at tz, plankbnd [ncol][16] = semiss * row at tbound and,
// unless dtab is null, dplankbnd likewise from dtab; both tables
// [rows][16]. Tables, semiss and outputs 16-byte aligned.
extern "C" int lw_rows_planck(const float* tavel, const float* tz,
                              const float* tbound, const float* semiss,
                              const float* tab, const float* dtab,
                              float* planklay, float* planklev,
                              float* plankbnd, float* dplankbnd,
                              int nlay_pts, int nlev_pts, int ncol, int rows,
                              void* stream) {
    const bool deriv = dtab != nullptr;
    if (nlay_pts < 0 || nlev_pts < 0 || ncol < 0 || nlay_pts > MAX_POINTS
        || nlev_pts > MAX_POINTS || ncol > MAX_POINTS || rows < 2
        || !aligned(tab) || !aligned(semiss) || !aligned(planklay)
        || !aligned(planklev) || !aligned(plankbnd)
        || (deriv && (!aligned(dtab) || !aligned(dplankbnd))))
        return static_cast<int>(cudaErrorInvalidValue);
    Rows a{};
    int blocks = 0;
    a.seg[0] = segment(tavel, tab, planklay, nlay_pts, rows, 159.0f,
                       &blocks);
    a.seg[1] = segment(tz, tab, planklev, nlev_pts, rows, 159.0f, &blocks);
    a.seg[2] = segment(tbound, tab, plankbnd, ncol, rows, 159.0f, &blocks);
    a.semiss = reinterpret_cast<const float4*>(semiss);
    a.dtab = reinterpret_cast<const float4*>(dtab);
    a.dout = deriv ? reinterpret_cast<float4*>(dplankbnd) : nullptr;
    return launch<PLANCK>(a, blocks, stream);
}
