// K11: QuickBeam's DSD integrals, path integral and dBZe in one launch.
//
// Replaces no TPU kernel: in the JAX package XLA computes this stage
// (geosradiation_gridcomp_tpu/satsim/radar.py:quickbeam_simulator). It
// computes what the plain twin, satsim/radar.py:_quickbeam_block over
// every point, computes: per (point, subcolumn, level) and hydrometeor
// class with q > 1e-12 g/kg, the class's N(D) at the 85 sizes (lognormal,
// modified gamma or exponential with fixed N0, each with its re = 0
// branch), the trapezoid integrals of N(D) d^2 times the Mie backscatter
// and extinction efficiencies (and of N(D) d^6 for the Rayleigh
// reflectivity), summed over the classes; then, per (point, subcolumn),
// the two-way hydrometeor attenuation from the top down (the twin's
// trapezoid cumsum), and dbze, ze_non, h_atten (and ze_ray), MISSING_DBZ
// where the summed reflectivity is not > 0. The gas path (gases_liebe and
// its cumsum, [points, levels]) stays in PyTorch; the kernel subtracts it.
//
// The integral is linear in N(D): a trapezoid over the class's grid (D, or
// D_eq for the ice classes) is sum_k c_k N_k with c_k the half-widths of
// the grid times d_k^2 (d_k^6) times the efficiency at the volume's
// temperature row. Each class's N_k is a volume factor S times
// exp(alpha x_k^2 + beta x_k + gamma) times a static factor of k (D^(vu-1)
// for the gamma form, N0 for the exponential, 1/D for the lognormal, whose
// x_k is log D_k less a constant of the class; x_k = D_k otherwise), so
// satsim/radar_cuda.py folds the static factor, the widths, the unit
// factors and the efficiencies into one float4 per (class, temperature
// row, size): (z weight, attenuation weight, x_k, Rayleigh weight). A size
// is then one 16 B load, two FMAs for the exponent, one exp2f and two or
// three FMAs, whatever the class's form, and no N(D) plane is written.
//
// Bound on the H100 at 8,100 points x 50 subcolumns x 72 levels, 5
// classes: its bytes, the mixing ratios [5, points, subcolumns, levels]
// read once, four [points, levels] profiles and the three outputs, 0.28
// ms (benchmark/roofline/K11.py; the radii, which the work needs only
// where a class is present, and the size work, 85 exp2f and ~15 FP32
// instructions a present (volume, class), are left out: how many volumes
// hold a class is the scene's).
//
// Design: a block is 32 (point, subcolumn) rows by the level chunks, one
// thread a row's 8 levels (16 beyond 128 levels), so that a warp is one
// chunk of 32 rows: the subcolumns of one or two points, which share each
// level's temperature row. Every thread reads its chunk of each field 16 B
// at a time (whole sectors of its row) and keeps z, kr (and zr) in
// registers. Per (level, class) the warp ballots which lanes hold the
// class: where 16 or more do, each lane runs its own 85 sizes (the weight
// rows are broadcasts through L1); where fewer do, the warp takes their
// volumes one at a time, each lane 3 of the sizes (coalesced weight
// loads), and sums them with shuffles, so that a volume alone in its warp
// costs ~3 sizes of the warp's issue and not 85; a class no lane holds
// costs a ballot. The path integral is a scan over the chunks: each thread
// sums its chunk's trapezoid terms (the first from the chunk above through
// shared memory), the block shares the sums, and each thread starts its
// running sum from those of the chunks above it, in double. The outputs go
// out 16 B at a time. Measured on the H100 (PERF.md) on the COSP call
// of chip_smoke.py's satsim scene at 8,100 x 50 x 72, 971,205 present
// (volume, class) pairs of 145.8 M: 1.59 ms of device time; 1.03 ms with no class
// present (its loads and stores, ~1.5 GB), 9.4 ms with all five present
// everywhere. A thread per row walking its 72 levels in 4-level chunks
// took 3.65 / 3.62 / 12.7 ms: 18 chunks of dependent loads a thread, and
// every warp ran all 85 sizes for a volume present in one lane. With the
// register bound relaxed to 128 (114 used, two blocks an SM) the COSP call
// took 3.33 ms: the occupancy counts for more here than ptxas's spills at
// 64 registers in the RAY = false kernel. ptxas picks those 64 itself,
// and small changes tip it to 104-120 registers, fewer resident warps,
// and ~3.2 ms on the COSP call: staging the class parameters in
// shared memory through a loop did so (they are read from global memory,
// through L1), and so did reading the radii only in the chunks that hold
// their class (0.91 ms with no class present, against 1.04), which is why
// the radii are read with the mixing ratios (~583 MB of the ~1.5 GB).
// Forcing 64 registers with a second __launch_bounds__ argument took 1.65
// (radii where present) and 1.79 ms (radii everywhere).
//
// Numerics: float32, accurate exp2f, logf, powf and log10f (no fast-math).
// The twin rounds each N_k, each product and each trapezoid term; the
// kernel rounds the folded weights once (from float64) and sums in size
// order (or over the lanes), so a volume's reflectivity differs from the
// twin's by float rounding (~1e-7 relative, ~1e-5 dB). The fill decision,
// z > 0, is the same in both orders: every term is >= 0, and a present
// class's terms do not underflow at the mixing ratios and radii the radar
// takes.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;            // (point, subcolumn) rows a block
constexpr int MAX_CHUNKS = 16;      // threads a row, one a chunk of levels
constexpr int MAX_BLOCK = ROWS * MAX_CHUNKS;
constexpr int MAX_LEVELS = 16 * MAX_CHUNKS;   // chunks of 16 past 128
constexpr int ND = 85;              // sizes
constexpr int MAX_CLASSES = 9;      // the GEOS hydrometeor table's rows
constexpr int NPRM = 9;             // parameters a class
constexpr float Q_MIN = 1e-12f;     // the twin's `present`: q > 1e-12
constexpr float MISSING_DBZ = -999.0f;
constexpr float LOG2E = 1.44269504088896341f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DENSE = 16;           // from this many lanes holding a class
                                    // at a level, each runs its own sizes

// A class's parameters (satsim/radar_cuda.py:class_tables): [0] the DSD
// form (1 modified gamma, 2 exponential, 5 lognormal), [1] the first
// temperature of its efficiency table (C), [2] its last row; then per form
//   1: [3] G(vu+2), [4] G(vu+3), [5] D0 when re = 0, [6] vu + bpm,
//      [7] 1e-15 / (apm G(vu+bpm))
//   2: [3] apm G(1+bpm) N0, [4] 1 / (1 + bpm)
//   5: [3] exp(-2.5 ln(sg)^2), [4] rg when re = 0, [5] bpm,
//      [6] -0.5 / ln(sg)^2, [7] 0.5e-15 exp(-0.5 (bpm ln sg)^2)
//      / (apm sqrt(2 pi) ln(sg) 0.5e-6), [8] 2 / c with c the default
//      2 rg: the abscissa x_k is ln(D_k / c), and ln(2 rg / c) its centre
enum { P_FORM, P_T0, P_TLAST, P_A, P_B, P_C, P_D, P_E, P_F };

struct Args {
    const float* hm;        // [ncls, np, ncol, nlev] g/kg
    const float* re;        // [ncls, np, ncol, nlev] um
    const float* hgt;       // [np, nlev] km
    const float* p;         // [np, nlev] hPa
    const float* t;         // [np, nlev] C
    const float* gas;       // [np, nlev] dB, or null: no gas path
    const float4* wt;       // [ncls, ntemp, ND] weights
    const float* prm;       // [ncls, NPRM]
    float* dbze;            // [np, ncol, nlev]
    float* ze_non;
    float* h_atten;
    float* ze_ray;          // or null
    int* present;           // one int: (volume, class) pairs integrated
    int ncls, np, ncol, nlev, ntemp;
    float zconst;           // (wl^4 / pi^5) / |K|^2
};

// v[j] = row[l0 + j] for the levels of the chunk that exist, 0 beyond;
// with vec (nlev % 4 == 0) 16 B at a time
template <int CH>
__device__ __forceinline__ void load_chunk(const float* row, int l0,
                                           int nlev, bool vec, float* v) {
#pragma unroll
    for (int j = 0; j < CH; j += 4) {
        if (vec) {
            const float4 x = l0 + j < nlev
                ? __ldg(reinterpret_cast<const float4*>(row + l0 + j))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            v[j] = x.x;
            v[j + 1] = x.y;
            v[j + 2] = x.z;
            v[j + 3] = x.w;
        } else {
#pragma unroll
            for (int i = j; i < j + 4; ++i)
                v[i] = l0 + i < nlev ? __ldg(row + l0 + i) : 0.0f;
        }
    }
}

template <int CH>
__device__ __forceinline__ void store_chunk(float* row, int l0, int nlev,
                                            bool vec, const float* v) {
#pragma unroll
    for (int j = 0; j < CH; j += 4) {
        if (vec) {
            if (l0 + j < nlev)
                *reinterpret_cast<float4*>(row + l0 + j) =
                    make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else {
#pragma unroll
            for (int i = j; i < j + 4; ++i)
                if (l0 + i < nlev) row[l0 + i] = v[i];
        }
    }
}

__device__ __forceinline__ float to_dbz(float z) {
    return z > 0.0f ? 10.0f * log10f(fmaxf(z, 1e-30f)) : MISSING_DBZ;
}

// One present class at one volume: its row of weights and N(D)'s volume
// factor s and exponent, in base 2 (exp2f is a few instructions fewer
// than expf, and as accurate): N_k ~ s 2^(al x_k^2 + be x_k + ga).
struct Dsd {
    const float4* w;
    float al, be, ga, s;
};

__device__ __forceinline__ Dsd dsd(const Args& a, const float* cp, int c,
                                   float q, float re, float tc, float rho) {
    const int form = static_cast<int>(cp[P_FORM]);
    const int last = static_cast<int>(cp[P_TLAST]);
    int it = static_cast<int>(rintf(tc - cp[P_T0]));
    it = it < 0 ? 0 : it > last ? last : it;
    float al = 0.0f, be, ga = 0.0f, s;
    if (form == 1) {
        // modified gamma: N = S D^(vu-1) exp(-D / D0)
        const float d0 = re > 0.0f ? 2.0f * re * cp[P_A] / cp[P_B] : cp[P_C];
        be = -1.0f / d0;
        s = rho * q * cp[P_E] / powf(d0 * 1e-6f, cp[P_D]);
    } else if (form == 2) {
        // exponential, fixed N0: N = N0 exp(-lambda D), lambda from re or
        // from q (the twin's reciprocal, then the product)
        const float ld = re > 0.0f
            ? 1.0f / fmaxf(re, 1e-3f) * 1.5f
            : powf(1.0f / fmaxf(rho * q * 1e-3f, 1e-30f) * cp[P_A],
                   cp[P_B]) * 1e-6f;
        be = -ld;
        s = 1.0f;
    } else {
        // lognormal: N = S / D exp(-0.5 (ln(D / 2 rg) / ln sg)^2), the
        // square expanded about the class's centre: small where N peaks
        const float rg = re > 0.0f ? re * cp[P_A] : cp[P_B];
        const float lg = logf(rg * cp[P_F]);
        al = cp[P_D];
        be = -2.0f * lg * al;
        ga = lg * lg * al;
        s = rho * q * cp[P_E] / powf(2.0f * rg * 1e-6f, cp[P_C]);
    }
    return Dsd{a.wt + (static_cast<size_t>(c) * a.ntemp + it) * ND,
               al * LOG2E, be * LOG2E, ga * LOG2E, s};
}

// sum_k c_k 2^(...) over the sizes k0, k0 + step, ... < ND
template <bool RAY>
__device__ __forceinline__ void sizes(const Dsd& d, int k0, int step,
                                      float& sz, float& sk, float& sr) {
#pragma unroll 5
    for (int k = k0; k < ND; k += step) {
        const float4 wk = __ldg(d.w + k);
        const float e = exp2f(fmaf(fmaf(d.al, wk.z, d.be), wk.z, d.ga));
        sz = fmaf(wk.x, e, sz);
        sk = fmaf(wk.y, e, sk);
        if (RAY) sr = fmaf(wk.w, e, sr);
    }
}

__device__ __forceinline__ float warp_total(float v) {
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
    return v;
}

// One level of a warp's 32 rows, one class: adds each present volume's
// integrals to its lane's z, kr (and zr). Where most lanes hold the class,
// each lane runs its own 85 sizes; where few do, the warp takes the
// present volumes one at a time, each lane 3 of its sizes (coalesced
// weight loads), and sums them over the lanes: a lone present volume
// then costs the warp ~3 sizes, not 85.
template <bool RAY>
__device__ __forceinline__ void integrate(const Args& a, const float* cp,
                                          int c, bool present, float q,
                                          float re, float tc, float rho,
                                          float& z, float& kr, float& zr) {
    const unsigned m = __ballot_sync(FULL, present);
    if (!m) return;
    const Dsd d = present ? dsd(a, cp, c, q, re, tc, rho)
                          : Dsd{a.wt, 0.0f, 0.0f, 0.0f, 0.0f};
    if (__popc(m) >= DENSE) {
        float sz = 0.0f, sk = 0.0f, sr = 0.0f;
        if (present) sizes<RAY>(d, 0, 1, sz, sk, sr);
        z += d.s * sz;
        kr += d.s * sk;
        if (RAY) zr += d.s * sr;
        return;
    }
    const int lane = threadIdx.x;
    const int row = static_cast<int>(d.w - a.wt);
    for (unsigned left = m; left; left &= left - 1) {
        const int src = __ffs(left) - 1;
        const Dsd v{a.wt + __shfl_sync(FULL, row, src),
                    __shfl_sync(FULL, d.al, src), __shfl_sync(FULL, d.be, src),
                    __shfl_sync(FULL, d.ga, src), 0.0f};
        float sz = 0.0f, sk = 0.0f, sr = 0.0f;
        sizes<RAY>(v, lane, ROWS, sz, sk, sr);
        sz = warp_total(sz);
        sk = warp_total(sk);
        if (RAY) sr = warp_total(sr);
        if (lane == src) {
            z += d.s * sz;
            kr += d.s * sk;
            if (RAY) zr += d.s * sr;
        }
    }
}

template <int CH, bool RAY>
__global__ void __launch_bounds__(MAX_BLOCK) quickbeam_kernel(Args a) {
    __shared__ float kr_last[MAX_CHUNKS][ROWS];   // kr at a chunk's last level
    __shared__ double chunk_path[MAX_CHUNKS][ROWS];
    __shared__ int block_present;
    const int lane = threadIdx.x, ch = threadIdx.y;
    const int tid = lane + ROWS * ch;
    if (tid == 0) block_present = 0;
    __syncthreads();

    const int rows = a.np * a.ncol, nlev = a.nlev;
    const int r = blockIdx.x * ROWS + lane;
    const bool live = r < rows;
    const int l0 = ch * CH;
    const bool vec = nlev % 4 == 0;
    const size_t plane = static_cast<size_t>(rows) * nlev;
    const size_t off = static_cast<size_t>(r) * nlev;
    const size_t poff = static_cast<size_t>(live ? r / a.ncol : 0) * nlev;
    int count = 0;
    float z[CH], kr[CH], zr[CH], h[CH], tc[CH], rho[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j)
        z[j] = kr[j] = zr[j] = h[j] = tc[j] = rho[j] = 0.0f;
    if (live) {
        load_chunk<CH>(a.t + poff, l0, nlev, vec, tc);
        load_chunk<CH>(a.p + poff, l0, nlev, vec, rho);
        load_chunk<CH>(a.hgt + poff, l0, nlev, vec, h);
#pragma unroll
        for (int j = 0; j < CH; ++j)
            rho[j] = rho[j] * 100.0f / (287.0f * (tc[j] + 273.15f));
    }
    // every lane of a warp, live or not, takes part in its levels' ballots
    for (int c = 0; c < a.ncls; ++c) {
        float q[CH] = {}, re[CH] = {};
        if (live) {
            load_chunk<CH>(a.hm + c * plane + off, l0, nlev, vec, q);
            load_chunk<CH>(a.re + c * plane + off, l0, nlev, vec, re);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            const bool present = live && q[j] > Q_MIN;
            count += present;
            integrate<RAY>(a, a.prm + c * NPRM, c, present, q[j], re[j],
                           tc[j], rho[j], z[j], kr[j], zr[j]);
        }
    }
    // the path from the top, the twin's trapezoid: 2 x the running sum of
    // seg[l] = 0.5 (kr[l] + kr[l-1]) |h[l] - h[l-1]|; a chunk's first
    // term takes the level above it from the chunk before, and its running
    // sum starts from the sum of the chunks above (double, as the twin's
    // cumsum on the CPU accumulates)
    kr_last[ch][lane] = kr[CH - 1];
    const float h_above = live && l0 > 0 ? __ldg(a.hgt + poff + l0 - 1)
                                         : 0.0f;
    __syncthreads();
    const float kr_above = ch > 0 ? kr_last[ch - 1][lane] : 0.0f;
    auto seg = [&](int j) {
        const float kr_up = j > 0 ? kr[j - 1] : kr_above;
        const float h_up = j > 0 ? h[j - 1] : h_above;
        return l0 + j > 0 && l0 + j < nlev
            ? static_cast<double>(__fmul_rn(0.5f * (kr[j] + kr_up),
                                            fabsf(h[j] - h_up)))
            : 0.0;
    };
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < CH; ++j) sum += seg(j);
    chunk_path[ch][lane] = sum;
    __syncthreads();
    if (live && l0 < nlev) {
        double path = 0.0;
        for (int k = 0; k < ch; ++k) path += chunk_path[k][lane];
        float g[CH], o_dbz[CH], o_ze[CH], o_h[CH], o_r[CH];
        if (a.gas) {
            load_chunk<CH>(a.gas + poff, l0, nlev, vec, g);
        } else {
#pragma unroll
            for (int j = 0; j < CH; ++j) g[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            path += seg(j);
            const float att = 2.0f * static_cast<float>(path);
            const float zv = a.zconst * z[j];
            o_ze[j] = to_dbz(zv);
            o_dbz[j] = zv > 0.0f ? o_ze[j] - att - g[j] : MISSING_DBZ;
            o_h[j] = att;
            o_r[j] = to_dbz(zr[j]);
        }
        store_chunk<CH>(a.dbze + off, l0, nlev, vec, o_dbz);
        store_chunk<CH>(a.ze_non + off, l0, nlev, vec, o_ze);
        store_chunk<CH>(a.h_atten + off, l0, nlev, vec, o_h);
        if (RAY) store_chunk<CH>(a.ze_ray + off, l0, nlev, vec, o_r);
    }
    if (count) atomicAdd(&block_present, count);
    __syncthreads();
    if (tid == 0 && block_present) atomicAdd(a.present, block_present);
}

template <int CH>
int launch(const Args& a, cudaStream_t stream) {
    const dim3 grid((a.np * a.ncol + ROWS - 1) / ROWS),
        block(ROWS, (a.nlev + CH - 1) / CH);
    if (a.ze_ray)
        quickbeam_kernel<CH, true><<<grid, block, 0, stream>>>(a);
    else
        quickbeam_kernel<CH, false><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" int quickbeam(const float* hm, const float* re, const float* hgt,
                         const float* p, const float* t, const float* gas,
                         const float* wt, const float* prm, float* dbze,
                         float* ze_non, float* h_atten, float* ze_ray,
                         int* present, int ncls, int np, int ncol, int nlev,
                         int ntemp, float zconst, cudaStream_t stream) {
    if (ncls < 1 || ncls > MAX_CLASSES || np < 1 || ncol < 1 || nlev < 1
            || nlev > MAX_LEVELS)
        return cudaErrorInvalidValue;
    const Args a{hm, re, hgt, p, t, gas,
                 reinterpret_cast<const float4*>(wt), prm, dbze, ze_non,
                 h_atten, ze_ray, present, ncls, np, ncol, nlev, ntemp,
                 zconst};
    // 8 levels a thread up to 128 levels, 16 beyond
    return nlev <= 8 * MAX_CHUNKS ? launch<8>(a, stream)
                                  : launch<16>(a, stream);
}
