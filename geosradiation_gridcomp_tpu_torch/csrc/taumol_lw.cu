// K3: RRTMG-LW gas optical depths and Planck fractions (taumol).
//
// Replaces the TPU kernel geosradiation_gridcomp_tpu/models/rrtmg/
// taumol_lw_pallas.py:taumol_lw_fast and computes what the CPU oracle
// computes (models/rrtmg/taumol_lw.py, to the per-band spec taumol_lw_ref):
// for each of the 16 bands, the major-species (jp, jt) / (jp+1, jt1) x eta
// interpolation (9 eta points with the 0.125 / 0.875 straddle weights in the
// lower atmosphere, 5 above), minor species, self and foreign continua,
// halocarbons, the Planck fractions and the optional aerosol depth.
//
// Bound on the H100: table gathers, about 30 per (cell, g-point) from ~1.2 MB
// of k-tables that stay in L2, and writing taug and pfracs (660 MB at
// 8192 x 72 x 140). Design: one thread per (cell, band), blockIdx.y = band,
// so a warp never diverges over bands; the thread evaluates its cell's
// lower- or upper-atmosphere formula once per cell (species ratios, eta
// indices, column adjustments) and then loops over the band's g-points. The
// k-tables are one packed float32 vector; a per-band offset row says where
// each table starts (-1 if absent). The body is taumol_lw.cuh with every
// part on; taumol_lw_bisect.cu compiles it with parts left out (P3).

#include "taumol_lw.cuh"

extern "C" int taumol_lw(const float* fplanes, const int* iplanes,
                         const float* pack, const int* offsets,
                         const float* taua, float* taug, float* pfracs,
                         int ncells, int noffsets, void* stream) {
    return launch_taumol_lw<ALL>(fplanes, iplanes, pack, offsets, taua, taug,
                                 pfracs, ncells, noffsets, stream);
}
