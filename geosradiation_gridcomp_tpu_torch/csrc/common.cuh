// Shared definitions of the port's RRTMG kernels (LW: K1, K3, K4; SW: K2,
// K5, K6).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace geosrad {

constexpr int NGPT = 140;    // LW g-points
constexpr int NBND = 16;     // LW bands
constexpr int NGPT_SW = 112; // SW g-points
constexpr int NBND_SW = 14;  // SW bands 16..29

// g-point (0-based) -> band (0-based); NG_LW = 10 12 16 14 16 8 12 8 12 6
// 8 8 4 2 2 2, so the band starts are 0 10 22 38 52 68 76 88 96 108 114
// 122 130 134 136 138.
__device__ __forceinline__ int band_of(int g) {
    return (g >= 10) + (g >= 22) + (g >= 38) + (g >= 52) + (g >= 68)
         + (g >= 76) + (g >= 88) + (g >= 96) + (g >= 108) + (g >= 114)
         + (g >= 122) + (g >= 130) + (g >= 134) + (g >= 136) + (g >= 138);
}

// SW g-point (0-based) -> band (0-based, band 16 = 0); NG_SW = 6 12 8 8 10
// 10 2 10 8 6 6 8 6 12, so the band starts are 0 6 18 26 34 44 54 56 66 74
// 80 86 94 100.
__host__ __device__ constexpr int ng_sw(int b) {
    return b == 0 ? 6 : b == 1 ? 12 : b == 2 ? 8 : b == 3 ? 8
         : b == 4 ? 10 : b == 5 ? 10 : b == 6 ? 2 : b == 7 ? 10
         : b == 8 ? 8 : b == 9 ? 6 : b == 10 ? 6 : b == 11 ? 8
         : b == 12 ? 6 : 12;
}
__host__ __device__ constexpr int ngs_sw(int b) {
    int s = 0;
    for (int k = 0; k < b; ++k) s += ng_sw(k);
    return s;
}
__device__ __forceinline__ int band_of_sw(int g) {
    return (g >= 6) + (g >= 18) + (g >= 26) + (g >= 34) + (g >= 44)
         + (g >= 54) + (g >= 56) + (g >= 66) + (g >= 74) + (g >= 80)
         + (g >= 86) + (g >= 94) + (g >= 100);
}

// Sum over the 32 lanes of a warp, in a fixed order; lane 0 holds it.
__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

}  // namespace geosrad
