// McICA stochastic cloud subcolumn generator shared by K1 (mcica_lw.cu),
// K2 (mcica_sw.cu) and, through its raw draws, K7 (mcica_raw.cu).
//
// Computes what the CPU oracle's generate_stochastic_clouds computes for one
// subcolumn (g-point) of one column: the column's 4 threefry subkeys from
// the fractional Pa of its lowest four layers (column_subkey, the oracle's
// state_seed_ints + state_seed_key + split), the jax.random threefry-2x32
// stream of those subkeys (partitionable scheme, counter g*nlay + l), the
// two exponential-overlap forward fills run as a serial loop down the
// layers, the zcw condensate scaling read from the exact (3, 1000) class
// table, the cwp_tiny threshold, and the column's four clear-subcolumn
// flags (total, high, mid, low). Products that decide an index, a seed or
// feed an exact comparison use __fmul_rn/__fadd_rn/__fsub_rn, so no
// contraction into FMA changes their rounding from the plain PyTorch twin.
#pragma once

#include "common.cuh"

namespace geosrad {

constexpr int ZCW_N1 = 1000;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;

// The two words of a Threefry-2x32 output.
struct Words {
    uint32_t w0, w1;
};

// Threefry-2x32, 20 rounds, key (k0, k1), count words (0, ctr).
__device__ __forceinline__ Words threefry2(uint32_t k0, uint32_t k1,
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
    return Words{x0, x1};
}

// The draw's 32 random bits, w0 ^ w1 (jax.random's bits for uniform).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t ctr) {
    const Words w = threefry2(k0, k1, ctr);
    return w.w0 ^ w.w1;
}

#undef TF_ROUND

// jax.random.uniform's float in [0, 1) from 32 random bits.
__device__ __forceinline__ float unit_float(uint32_t bits) {
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Subkey i (0..3) of a column, as ops/mcica.py:subcolumn_keys derives it:
// the state seeds are the fractional Pa of the lowest four layers of play
// (hPa, TOA first), taken in the seed order (seed_order packs the four
// indices into 2-bit fields, entry j at bits 2j), each as
// uint32((p - floor(p)) * float32(2147483646) + 1) with p = play * 100;
// key (0, 0) is folded with the four seeds (fold_in(k, d) = threefry of
// (0, d)), then split: subkey i = threefry of (0, i).
__device__ __forceinline__ Words column_subkey(const float* play, int nlay,
                                               int seed_order, int i) {
    uint32_t k0 = 0u, k1 = 0u;
    for (int j = 0; j < 4; ++j) {
        const int s = (seed_order >> (2 * j)) & 3;
        const float p = __fmul_rn(play[nlay - 1 - s], 100.0f);
        // float32(2147483646) is 2^31; the sum can round up to it, so
        // the conversion is to unsigned, truncating as the oracle's cast
        const float v = __fadd_rn(__fmul_rn(__fsub_rn(p, floorf(p)),
                                            2147483648.0f), 1.0f);
        const Words w = threefry2(k0, k1, __float2uint_rz(v));
        k0 = w.w0;
        k1 = w.w1;
    }
    return threefry2(k0, k1, static_cast<uint32_t>(i));
}

// Threads 0..3 of a column (t = the thread's index within the column) each
// write one of the column's subkeys into keys[8]; the caller synchronises
// before the generator reads them.
__device__ __forceinline__ void column_subkeys(const float* play, int nlay,
                                               int seed_order, int t,
                                               uint32_t* keys) {
    if (t < 4) {
        const Words w = column_subkey(play, nlay, seed_order, t);
        keys[2 * t] = w.w0;
        keys[2 * t + 1] = w.w1;
    }
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
                            // (column_subkeys, or K7's input)
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

// The raw draws of subcolumn g down the column: calls raw(l, cl, c3) for
// each layer with the presence test c1 >= 1 - cldf of the forward-filled
// presence cdf c1 and, where cond, the forward-filled condensate cdf c3
// (0 where not cond). Only alpha, rcorr and cldf of the column are read.
template <class Raw>
__device__ __forceinline__ void draws(const Column& c, int g, bool cond,
                                      Raw&& raw) {
    const uint32_t* k = c.keys;
    float c1 = 0.0f, c3 = 0.0f;
    for (int l = 0; l < c.nlay; ++l) {
        const uint32_t ctr = static_cast<uint32_t>(g * c.nlay + l);
        // presence chain: keep this layer's draw where cdf2 >= alpha
        const float u1 = unit_float(threefry_bits(k[0], k[1], ctr));
        const float u2 = unit_float(threefry_bits(k[2], k[3], ctr));
        if (l == 0 || u2 >= c.alpha[l]) c1 = u1;
        if (cond) {
            // condensate chain
            const float u3 = unit_float(threefry_bits(k[4], k[5], ctr));
            const float u4 = unit_float(threefry_bits(k[6], k[7], ctr));
            if (l == 0 || u3 >= c.rcorr[l]) c3 = u4;
        }
        raw(l, c1 >= 1.0f - c.cldf[l], c3);
    }
}

// Subcolumn g down the column: calls layer(l, cloudy, ciwp, clwp) for each
// layer with the subcolumn's cloudy flag and water paths (zero where not
// cloudy or below cwp_tiny); returns the clear flags.
template <class Layer>
__device__ __forceinline__ CloudFlags subcolumn(const Column& c, int g,
                                                Layer&& layer) {
    CloudFlags f;
    draws(c, g, c.inhm != 0, [&](int l, bool cl, float c3) {
        const float z = c.inhm != 0 ? zcw_lookup(c.zcw, c.sigcls[l], c3)
                                    : 1.0f;
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
    });
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
