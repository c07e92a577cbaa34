// McICA stochastic cloud subcolumn generator shared by K1 (mcica_lw.cu)
// and K2 (mcica_sw.cu).
//
// Computes what the CPU oracle's generate_stochastic_clouds computes for one
// subcolumn (g-point) of one column: the jax.random threefry-2x32 stream of
// the 4 per-column subkeys (partitionable scheme, counter g*nlay + l), the
// two exponential-overlap forward fills run as a serial loop down the
// layers, the zcw condensate scaling read from the exact (3, 1000) class
// table, the cwp_tiny threshold, and the column's four clear-subcolumn
// flags (total, high, mid, low). Products that decide an index or feed an
// exact comparison use __fmul_rn/__fadd_rn, so no contraction into FMA
// changes their rounding from the plain PyTorch twin.
#pragma once

#include "common.cuh"

namespace geosrad {

constexpr int ZCW_N1 = 1000;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;

// Threefry-2x32, 20 rounds, count words (0, ctr): returns w0 ^ w1.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t ctr) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t x0 = k0;
    uint32_t x1 = ctr + k1;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k2; x1 += k0 + 5u;
    return x0 ^ x1;
}

#undef TF_ROUND

// jax.random.uniform's float in [0, 1) from 32 random bits.
__device__ __forceinline__ float unit_float(uint32_t bits) {
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Condensate scaling: linear in the cdf along the class column.
__device__ __forceinline__ float zcw_lookup(const float* zcw, int cls,
                                            float cdf) {
    const float rind1 = __fadd_rn(__fmul_rn(cdf, float(ZCW_N1 - 1)), 1.0f);
    int ind1 = static_cast<int>(floorf(rind1));
    ind1 = ind1 < 1 ? 1 : (ind1 > ZCW_N1 - 1 ? ZCW_N1 - 1 : ind1);
    const float f1 = __fsub_rn(rind1, static_cast<float>(ind1));
    const float lo = zcw[cls * ZCW_N1 + ind1 - 1];
    const float hi = zcw[cls * ZCW_N1 + ind1];
    return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.0f, f1)), __fmul_rn(hi, f1));
}

// Whether any subcolumn layer of the column is cloudy, per super-layer.
struct CloudFlags {
    bool tot = false, high = false, mid = false, low = false;
};

// Per-column arguments of the generator.
struct Column {
    const uint32_t* keys;   // this column's 4 subkeys, [4][2]
    const float* alpha;     // rows of this column, [nlay]
    const float* rcorr;
    const float* cldf;
    const float* ciwp;
    const float* clwp;
    const int* sigcls;
    const float* zcw;       // the (3, 1000) class table (shared memory)
    int nlay, cloud_mh, cloud_lm, inhm;
    float cwp_tiny;
};

// Whether the column has cloud fraction anywhere (a clear column skips the
// generator: every subcolumn is clear).
__device__ __forceinline__ bool any_cloud(const Column& c) {
    bool any = false;
    for (int l = 0; l < c.nlay; ++l) any = any || c.cldf[l] > 0.0f;
    return any;
}

// Subcolumn g down the column: calls layer(l, cloudy, ciwp, clwp) for each
// layer with the subcolumn's cloudy flag and water paths (zero where not
// cloudy or below cwp_tiny); returns the clear flags.
template <class Layer>
__device__ __forceinline__ CloudFlags subcolumn(const Column& c, int g,
                                                Layer&& layer) {
    CloudFlags f;
    const uint32_t* k = c.keys;
    float c1 = 0.0f, c3 = 0.0f;
    for (int l = 0; l < c.nlay; ++l) {
        const uint32_t ctr = static_cast<uint32_t>(g * c.nlay + l);
        // presence chain: keep this layer's draw where cdf2 >= alpha
        const float u1 = unit_float(threefry_bits(k[0], k[1], ctr));
        const float u2 = unit_float(threefry_bits(k[2], k[3], ctr));
        if (l == 0 || u2 >= c.alpha[l]) c1 = u1;
        const bool cl = c1 >= 1.0f - c.cldf[l];
        float z = 1.0f;
        if (c.inhm != 0) {
            // condensate chain
            const float u3 = unit_float(threefry_bits(k[4], k[5], ctr));
            const float u4 = unit_float(threefry_bits(k[6], k[7], ctr));
            if (l == 0 || u3 >= c.rcorr[l]) c3 = u4;
            z = zcw_lookup(c.zcw, c.sigcls[l], c3);
        }
        float ci = cl ? __fmul_rn(c.ciwp[l], z) : 0.0f;
        float cw = cl ? __fmul_rn(c.clwp[l], z) : 0.0f;
        if (ci <= c.cwp_tiny) ci = 0.0f;
        if (cw <= c.cwp_tiny) cw = 0.0f;
        const bool cy = cl && (ci > 0.0f || cw > 0.0f);
        layer(l, cy, ci, cw);
        if (cy) {
            f.tot = true;
            if (l < c.cloud_mh - 1) f.high = true;
            if (l >= c.cloud_mh - 1 && l < c.cloud_lm - 1) f.mid = true;
            if (l >= c.cloud_lm - 1) f.low = true;
        }
    }
    return f;
}

// Adds one subcolumn's clear flags to the block's four counters.
__device__ __forceinline__ void count_clear(int* clear, const CloudFlags& f) {
    atomicAdd(&clear[0], f.tot ? 0 : 1);
    atomicAdd(&clear[1], f.high ? 0 : 1);
    atomicAdd(&clear[2], f.mid ? 0 : 1);
    atomicAdd(&clear[3], f.low ? 0 : 1);
}

}  // namespace geosrad
