// P3: cost bisection of taumol-LW (K3) by parts compiled out.
//
// Replaces the TPU micro-kernel tools/profiling/taumol_lw_bisect.py:make,
// which builds reduced variants of the TPU taumol-LW kernel so that the
// differences of their times attribute the kernel's cost. Here each
// variant is K3's own body (taumol_lw.cuh) compiled with a mask of parts:
// MAJOR (major species), MINOR (minor species and halocarbons), CONT (self
// and foreign continua), PLANCK (Planck fractions). A part that is off
// contributes 0 and its table reads are dropped; the stores of taug and
// pfracs always happen, so the variant with no part (store_only) times the
// cell loads, the per-cell set-up and the stores alone. With every part on
// the kernel is K3's, bit for bit.
//
// Bound on the H100: as K3 (table gathers, then the 660 MB of stores at
// 8192 x 72 x 140); the design is K3's.

#include "taumol_lw.cuh"

namespace {

template <unsigned P>
int run(const float* fplanes, const int* iplanes, const float* pack,
        const int* offsets, float* taug, float* pfracs, int ncells,
        int noffsets, void* stream) {
    return launch_taumol_lw<P>(fplanes, iplanes, pack, offsets, nullptr,
                               taug, pfracs, ncells, noffsets, stream);
}

}  // namespace

// parts: the mask of one variant (models/rrtmg/taumol_lw.py:VARIANTS).
extern "C" int taumol_lw_bisect(const float* fplanes, const int* iplanes,
                                const float* pack, const int* offsets,
                                float* taug, float* pfracs, int ncells,
                                int noffsets, int parts, void* stream) {
    switch (parts) {
        case ALL:
            return run<ALL>(fplanes, iplanes, pack, offsets, taug, pfracs,
                            ncells, noffsets, stream);
        case MAJOR | MINOR | PLANCK:
            return run<MAJOR | MINOR | PLANCK>(fplanes, iplanes, pack,
                                               offsets, taug, pfracs, ncells,
                                               noffsets, stream);
        case MAJOR | CONT | PLANCK:
            return run<MAJOR | CONT | PLANCK>(fplanes, iplanes, pack, offsets,
                                              taug, pfracs, ncells, noffsets,
                                              stream);
        case MAJOR | MINOR | CONT:
            return run<MAJOR | MINOR | CONT>(fplanes, iplanes, pack, offsets,
                                             taug, pfracs, ncells, noffsets,
                                             stream);
        case MAJOR:
            return run<MAJOR>(fplanes, iplanes, pack, offsets, taug, pfracs,
                              ncells, noffsets, stream);
        case MINOR:
            return run<MINOR>(fplanes, iplanes, pack, offsets, taug, pfracs,
                              ncells, noffsets, stream);
        case 0:
            return run<0>(fplanes, iplanes, pack, offsets, taug, pfracs,
                          ncells, noffsets, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
