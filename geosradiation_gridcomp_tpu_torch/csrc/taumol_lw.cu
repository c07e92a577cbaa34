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
// Bound on the H100: writing taug and pfracs (660 MB at 8192 x 72 x 140,
// ~0.2 ms at 3.35 TB/s) against ~75 MB of per-cell planes read, and the
// ~30 gathers per (cell, g-point) from ~1.2 MB of k-tables, which must hit
// in L1 or L2 without flooding them. The first design, one thread per
// (cell, band) storing its NG floats at a stride of 140 floats and
// reloading its cell's 32 planes for each band, was bound by that data
// movement (cost bisection P3). Design: one block per tile of 32
// columns at one layer, so that the lanes of a warp (one column each) read
// nearly the same table rows; eight warps, each evaluating two bands for
// the tile's cells (a warp never diverges over bands); the tile's planes
// loaded once into shared memory; the tile's rows of both outputs
// assembled in shared memory (rows padded to 141 floats against bank
// conflicts) and written back as 16-byte stores, one contiguous 560-byte
// run per cell and output. Each thread evaluates its band's lower- or
// upper-atmosphere formula once per cell (species ratios, eta indices,
// column adjustments) and loops over the band's g-points. The k-tables are
// one packed float32 vector; a per-band offset row says where each table
// starts (-1 if absent). The body is taumol_lw.cuh with every part on;
// taumol_lw_bisect.cu compiles it with parts left out (P3).

#include "taumol_lw.cuh"

extern "C" int taumol_lw(const float* fplanes, const int* iplanes,
                         const float* pack, const int* offsets,
                         const float* taua, float* taug, float* pfracs,
                         int ncol, int nlay, int noffsets, void* stream) {
    return launch_taumol_lw<ALL>(fplanes, iplanes, pack, offsets, taua, taug,
                                 pfracs, ncol, nlay, noffsets, stream);
}
