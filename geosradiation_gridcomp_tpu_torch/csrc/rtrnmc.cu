// K4: RRTMG-LW no-scattering radiative transfer with McICA clouds (rtrnmc).
//
// Replaces the TPU kernels of geosradiation_gridcomp_tpu/models/rrtmg/
// rtrnmc_pallas.py:rtrnmc_fast (a down-sweep pallas_call and an up-sweep
// pallas_call) and computes what the CPU oracle models/rrtmg/rtrnmc.py
// computes: diffusivity secant per band, layer absorptivity and the linear-
// in-tau Planck source (tfn) for the gas-only and the gas+cloud paths, a
// TOA->surface sweep for all-sky and clear sky, surface emission and
// reflection, a surface->TOA sweep with the dF/dTs Jacobians, and band OLR.
//
// Bound on the H100: reading taug, pfracs and taucmc (3 x 4 B per cell and
// g-point, ~1 GB at 8192 x 72 x 140; ~2 GB, 0.59 ms, as the up sweep reads
// them again). What holds it back in practice is instruction issue: per
// layer and g-point two expf and two tfn in a serial chain (PERF.md).
// Design: one block per column, one thread per g-point (160 threads, 140
// active), both sweeps in registers in ONE launch. So that no load stalls
// the chain, each thread keeps a ring of the next DEPTH - 1 layers' three
// values in shared memory, filled with asynchronous copies (cp.async); the
// up sweep re-reads its inputs through the same ring (storing the down
// sweep's optics would cost more bytes than reading them again). The
// column's Planck rows and cloud flags are loaded into shared memory once.
// Each level's band-weighted sums over g are reduced a batch of levels at a
// time: a thread keeps 32 values (levels x fields) in registers and the
// warp sums all 32 with one transposing butterfly (31 shuffles, where a
// warp sum per value takes 5); after each batch one warp adds the 5 warps'
// sums in a fixed order, so the result is run-to-run identical. The band
// widths and the diffusivity coefficients are compiled in, so the wrapper
// copies nothing from the host.

#include <cuda_pipeline_primitives.h>

#include "common.cuh"

namespace {

using namespace geosrad;

constexpr int BLOCK = 160;
constexpr int NWARP = BLOCK / 32;
constexpr int DEPTH = 4;   // ring slots per thread: DEPTH - 1 layers in flight
constexpr int NDN = 2;     // fields summed per level in the down sweep
constexpr int NUP = 4;     // and in the up sweep
constexpr int KDN = 32 / NDN;  // levels per reduction batch
constexpr int KUP = 32 / NUP;
static_assert((DEPTH & (DEPTH - 1)) == 0, "DEPTH is a power of two");

// band-width weight per band (W/m^2 per unit radiance): DELWAVE_G of
// models/rrtmg/rtrnmc.py, 0.5 * (wavenum2 - wavenum1) * pi * 2e4 in double,
// rounded to float32 as there
constexpr double FLUXFAC = 3.141592653589793 * 2.0e4;
__constant__ float DELWAVE[NBND] = {
    static_cast<float>(0.5 * 340.0 * FLUXFAC),
    static_cast<float>(0.5 * 150.0 * FLUXFAC),
    static_cast<float>(0.5 * 130.0 * FLUXFAC),
    static_cast<float>(0.5 * 70.0 * FLUXFAC),
    static_cast<float>(0.5 * 120.0 * FLUXFAC),
    static_cast<float>(0.5 * 160.0 * FLUXFAC),
    static_cast<float>(0.5 * 100.0 * FLUXFAC),
    static_cast<float>(0.5 * 100.0 * FLUXFAC),
    static_cast<float>(0.5 * 210.0 * FLUXFAC),
    static_cast<float>(0.5 * 90.0 * FLUXFAC),
    static_cast<float>(0.5 * 320.0 * FLUXFAC),
    static_cast<float>(0.5 * 280.0 * FLUXFAC),
    static_cast<float>(0.5 * 170.0 * FLUXFAC),
    static_cast<float>(0.5 * 130.0 * FLUXFAC),
    static_cast<float>(0.5 * 220.0 * FLUXFAC),
    static_cast<float>(0.5 * 650.0 * FLUXFAC)};

// variable diffusivity-angle coefficients (rtrnmc.F90:131-146) of the bands
// 2, 3, 5-9 (bit b-1 set); the others take 1.66
constexpr unsigned VARIABLE_SECDIFF = 0x1F6u;
__constant__ float A0[NBND] = {1.66f, 1.55f, 1.58f, 1.66f, 1.54f, 1.454f,
                               1.89f, 1.33f, 1.668f, 1.66f, 1.66f, 1.66f,
                               1.66f, 1.66f, 1.66f, 1.66f};
__constant__ float A1[NBND] = {0.00f, 0.25f, 0.22f, 0.00f, 0.13f, 0.446f,
                               -0.10f, 0.40f, -0.006f, 0.00f, 0.00f, 0.00f,
                               0.00f, 0.00f, 0.00f, 0.00f};
__constant__ float A2[NBND] = {0.00f, -12.0f, -11.7f, 0.00f, -0.72f,
                               -0.243f, 0.19f, -0.062f, 0.414f, 0.00f, 0.00f,
                               0.00f, 0.00f, 0.00f, 0.00f, 0.00f};

// secdiff_band of models/rrtmg/rtrnmc.py for band b, with its operations
// unfused as there
__device__ __forceinline__ float secdiff(int b, float pwvcm) {
    if (!((VARIABLE_SECDIFF >> b) & 1u)) return 1.66f;
    const float e = expf(__fmul_rn(A2[b], pwvcm));
    const float s = __fadd_rn(A0[b], __fmul_rn(A1[b], e));
    return fminf(fmaxf(s, 1.5f), 1.8f);
}

// The linear-in-tau Planck transition function, tr = exp(-tau); the
// series tau / 6 below the reference's 0.06 switch. Its divisions are
// __fdividef (2 ulp): with IEEE division K4 took 1.81 ms at 8192 x 72 on
// the H100, with these 1.15 (PERF.md); both reciprocals' denominators
// (tau >= 0.06, 1 - tr >= 1e-12) stay far below the 2^126 where
// __fdividef returns 0, and tau / 6 is a product with 1/6 (1 ulp).
__device__ __forceinline__ float tfn(float tau, float tr) {
    if (tau < 0.06f) return tau * (1.0f / 6.0f);
    const float safe = fmaxf(tau, 1e-9f);
    return 1.0f - 2.0f * (__fdividef(1.0f, safe)
                          - __fdividef(tr, fmaxf(1.0f - tr, 1e-12f)));
}

struct LayerOptics {
    float a;       // absorptivity of the stream (cloudy or gas-only)
    float ag;      // gas-only absorptivity
    float tf;      // tfn of the stream
    float tfg;     // gas-only tfn
    bool cld;
};

// The optics of one layer for one g-point. The cloudy path (a second
// expf and tfn) is taken only where some g-point of the warp sees cloud, so
// the warps of a clear layer skip it; its result is the same either way.
__device__ __forceinline__ LayerOptics layer_optics(float sec, float tg,
                                                    float tc) {
    LayerOptics o;
    const float odg = fmaxf(sec * tg, 0.0f);
    const float trg = expf(-odg);
    o.ag = 1.0f - trg;
    o.tfg = tfn(odg, trg);
    o.cld = tc > 0.0f;
    o.a = o.ag;
    o.tf = o.tfg;
    if (__any_sync(0xffffffffu, o.cld)) {
        const float odt = odg + sec * tc;
        const float trt = expf(-odt);
        if (o.cld) {
            o.a = 1.0f - trt;
            o.tf = tfn(odt, trt);
        }
    }
    return o;
}

// One step of warp_sums32: a lane holding 2 OFF values keeps the OFF its
// partner (lane ^ OFF) does not, plus the partner's copy of them.
template <int OFF>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
    const bool hi = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < OFF; ++j) {
        const float send = hi ? v[j] : v[j + OFF];
        const float keep = hi ? v[j + OFF] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

// The sums over the warp's 32 lanes of v[0..31], all at once: 16 + 8 + 4 +
// 2 + 1 shuffles leave lane i with the sum of v[i], every value summed in
// the same fixed butterfly order.
__device__ __forceinline__ float warp_sums32(float (&v)[32], int lane) {
    fold<16>(v, lane);
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    fold<1>(v, lane);
    return v[0];
}

__global__ void __launch_bounds__(BLOCK)
rtrnmc_kernel(const float* __restrict__ semiss,
              const float* __restrict__ pwvcm,
              const float* __restrict__ taug,
              const float* __restrict__ pfracs,
              const float* __restrict__ taucmc,
              const unsigned char* __restrict__ cloudy,
              const float* __restrict__ planklay,
              const float* __restrict__ planklev,
              const float* __restrict__ plankbnd,
              const float* __restrict__ dplankbnd,
              float* __restrict__ uflx, float* __restrict__ dflx,
              float* __restrict__ uflxc, float* __restrict__ dflxc,
              float* __restrict__ duflx, float* __restrict__ duflxc,
              float* __restrict__ olrb, float* __restrict__ dolrb,
              int nlay) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    const int nlev = nlay + 1;
    float* ring = reinterpret_cast<float*>(dyn_smem);   // [DEPTH][3][BLOCK]
    float* blay = ring + DEPTH * 3 * BLOCK;            // [nlay][NBND]
    float* blev = blay + nlay * NBND;                  // [nlev][NBND]
    unsigned char* cld = reinterpret_cast<unsigned char*>(blev + nlev * NBND);
    __shared__ float red[2][NWARP][32];   // a batch's warp sums, two batches
    __shared__ float top[2][NGPT];

    const int col = blockIdx.x;
    const int t = threadIdx.x;
    const int warp = t / 32;
    const int lane = t % 32;
    const bool active = t < NGPT;
    // an idle thread runs g-point 0 with weight 0
    const int g = active ? t : 0;
    const int band = band_of(g);
    const float w = active ? DELWAVE[band] : 0.0f;
    const float sec = secdiff(band, pwvcm[col]);
    const float pbnd = plankbnd[col * NBND + band];
    const float dpbnd = dplankbnd[col * NBND + band];
    const float refl = 1.0f - semiss[col * NBND + band];

    // Position s of the layer sequence: layer s of the down sweep for
    // s < nlay, layer 2 nlay - 1 - s of the up sweep after. Every call
    // commits one group (empty past the end), so that a wait for all but
    // the newest DEPTH - 2 groups completes position s at step s.
    const size_t base = static_cast<size_t>(col) * nlay * NGPT + g;
    auto fetch = [&](int s) {
        if (s < 2 * nlay) {
            const int l = s < nlay ? s : 2 * nlay - 1 - s;
            const size_t o = base + static_cast<size_t>(l) * NGPT;
            float* r = ring + (s & (DEPTH - 1)) * 3 * BLOCK + t;
            __pipeline_memcpy_async(r, taug + o, sizeof(float));
            __pipeline_memcpy_async(r + BLOCK, pfracs + o, sizeof(float));
            __pipeline_memcpy_async(r + 2 * BLOCK, taucmc + o, sizeof(float));
        }
        __pipeline_commit();
    };
    // Position s into registers, then the refill of the slot that step s - 1
    // read (its values were used a step ago), DEPTH - 1 positions ahead.
    auto take = [&](int s, float& tg, float& pf, float& tc) {
        __pipeline_wait_prior(DEPTH - 2);
        const float* r = ring + (s & (DEPTH - 1)) * 3 * BLOCK + t;
        tg = r[0];
        pf = r[BLOCK];
        tc = r[2 * BLOCK];
        fetch(s + DEPTH - 1);
    };
    for (int s = 0; s < DEPTH - 1; ++s) fetch(s);

    const float* pl = planklay + static_cast<size_t>(col) * nlay * NBND;
    const float* pv = planklev + static_cast<size_t>(col) * nlev * NBND;
    for (int i = t; i < nlay * NBND; i += BLOCK) blay[i] = pl[i];
    for (int i = t; i < nlev * NBND; i += BLOCK) blev[i] = pv[i];
    for (int i = t; i < nlay; i += BLOCK)
        cld[i] = cloudy[static_cast<size_t>(col) * nlay + i];
    __syncthreads();

    // Each warp puts its sum of value i of the batch (lane i) in red; after
    // the barrier warp 0 adds the warps' sums in warp order and writes
    // value i to out (if it is a level). Two buffers: a batch's sums are
    // written after the barrier that followed warp 0's reading of the
    // buffer two batches back.
    int batch = 0;
    auto flush = [&](float sum, float* out) {
        float* r = red[batch & 1][0];
        r[warp * 32 + lane] = sum;
        __syncthreads();
        if (warp == 0 && out != nullptr) {
            float s = 0.0f;
            for (int k = 0; k < NWARP; ++k) s += r[k * 32 + lane];
            *out = s;
        }
        ++batch;
    };
    const size_t lev0 = static_cast<size_t>(col) * nlev;

    // ---- downward sweep (TOA -> surface): level q from layer q - 1;
    // dflx = 0 at TOA ----
    float radld = 0.0f, radclrd = 0.0f, pfs = 0.0f;
    bool div = false;
    for (int q0 = 0; q0 < nlev; q0 += KDN) {
        float v[32];
#pragma unroll
        for (int k = 0; k < KDN; ++k) {
            const int q = q0 + k;
            if (q > 0 && q < nlev) {
                const int l = q - 1;
                float tg, pf, tc;
                take(l, tg, pf, tc);
                const LayerOptics op = layer_optics(sec, tg, tc);
                const float bl = blay[l * NBND + band];
                const float dn = blev[(l + 1) * NBND + band] - bl;
                const float bbdg = pf * (bl + op.tfg * dn);
                const float bbd = op.cld ? pf * (bl + op.tf * dn) : bbdg;
                div = div || (cld[l] != 0);
                const float radld_n = radld + (bbd - radld) * op.a;
                radclrd = div ? radclrd + (bbdg - radclrd) * op.ag : radld_n;
                radld = radld_n;
                pfs = pf;
            }
            v[NDN * k] = radld * w;
            v[NDN * k + 1] = radclrd * w;
        }
        // lane i holds value i: level q0 + i / NDN of dflx or dflxc
        const int q = q0 + lane / NDN;
        float* out = lane % NDN == 0 ? dflx : dflxc;
        flush(warp_sums32(v, lane), q < nlev ? out + lev0 + q : nullptr);
    }

    // ---- surface emission and reflection (pfs: the bottom layer's
    // Planck fraction) ----
    const float rad0 = pfs * pbnd;
    float radlu = rad0 + refl * radld;
    float radclru = rad0 + refl * radclrd;
    float dlu = pfs * dpbnd;
    float dclru = dlu;

    // ---- upward sweep (surface -> TOA): level nlay - q from layer
    // nlay - q; the divergence flag stays at the column's final "any layer
    // cloudy" ----
    for (int q0 = 0; q0 < nlev; q0 += KUP) {
        float v[32];
#pragma unroll
        for (int k = 0; k < KUP; ++k) {
            const int q = q0 + k;
            if (q > 0 && q < nlev) {
                const int l = nlay - q;
                float tg, pf, tc;
                take(nlay + q - 1, tg, pf, tc);
                const LayerOptics op = layer_optics(sec, tg, tc);
                const float bl = blay[l * NBND + band];
                const float up = blev[l * NBND + band] - bl;
                const float bbug = pf * (bl + op.tfg * up);
                const float bbu = op.cld ? pf * (bl + op.tf * up) : bbug;
                const float radlu_n = radlu + (bbu - radlu) * op.a;
                const float dlu_n = dlu * (1.0f - op.a);
                radclru = div ? radclru + (bbug - radclru) * op.ag : radlu_n;
                dclru = div ? dclru * (1.0f - op.ag) : dlu_n;
                radlu = radlu_n;
                dlu = dlu_n;
            }
            v[NUP * k] = radlu * w;
            v[NUP * k + 1] = radclru * w;
            v[NUP * k + 2] = dlu * w;
            v[NUP * k + 3] = dclru * w;
        }
        // lane i holds value i: level nlay - (q0 + i / NUP) of uflx,
        // uflxc, duflx_dts or duflxc_dts
        const int q = q0 + lane / NUP;
        const int i = lane % NUP;
        float* out = i == 0 ? uflx : i == 1 ? uflxc : i == 2 ? duflx : duflxc;
        flush(warp_sums32(v, lane), q < nlev ? out + lev0 + nlay - q : nullptr);
    }
    if (active) {
        top[0][t] = radlu * w;
        top[1][t] = dlu * w;
    }
    __syncthreads();

    if (t < 2 * NBND) {
        // band OLR and its Ts derivative: sums over the band's g-points
        const int b = t % NBND;
        const int which = t / NBND;
        int g0 = 0;
        while (band_of(g0) != b) ++g0;
        float s = 0.0f;
        for (int k = g0; k < NGPT && band_of(k) == b; ++k) s += top[which][k];
        (which == 0 ? olrb : dolrb)[col * NBND + b] = s;
    }
}

}  // namespace

extern "C" int rtrnmc_lw(const float* semiss, const float* pwvcm,
                         const float* taug, const float* pfracs,
                         const float* taucmc, const unsigned char* cloudy,
                         const float* planklay, const float* planklev,
                         const float* plankbnd, const float* dplankbnd,
                         float* uflx, float* dflx, float* uflxc,
                         float* dflxc, float* duflx, float* duflxc,
                         float* olrb, float* dolrb,
                         int ncol, int nlay, void* stream) {
    if (ncol <= 0 || nlay <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nlev = nlay + 1;
    const size_t smem = sizeof(float) * (DEPTH * 3 * BLOCK + (nlay + nlev) * NBND)
                        + nlay;
    if (smem > 48 * 1024) {
        const int rc = static_cast<int>(cudaFuncSetAttribute(
            rtrnmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem)));
        if (rc != 0) return rc;
    }
    rtrnmc_kernel<<<ncol, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        semiss, pwvcm, taug, pfracs, taucmc, cloudy, planklay, planklev,
        plankbnd, dplankbnd, uflx, dflx, uflxc, dflxc, duflx, duflxc, olrb,
        dolrb, nlay);
    return static_cast<int>(cudaGetLastError());
}
