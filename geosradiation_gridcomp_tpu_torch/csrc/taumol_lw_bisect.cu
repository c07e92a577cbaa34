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
// Bound on the H100: as K3 (the 660 MB of stores at 8192 x 72 x 140, then
// the table gathers); the design is K3's: one block per tile of 32 columns
// at one layer, each warp two bands, the outputs assembled in shared
// memory.

#include "taumol_lw.cuh"

namespace {

template <unsigned P>
int run(const float* fplanes, const int* iplanes, const float* pack,
        const int* offsets, float* taug, float* pfracs, int ncol, int nlay,
        int noffsets, void* stream) {
    return launch_taumol_lw<P>(fplanes, iplanes, pack, offsets, nullptr,
                               taug, pfracs, ncol, nlay, noffsets, stream);
}

}  // namespace

// parts: the mask of one variant (models/rrtmg/taumol_lw.py:VARIANTS).
extern "C" int taumol_lw_bisect(const float* fplanes, const int* iplanes,
                                const float* pack, const int* offsets,
                                float* taug, float* pfracs, int ncol,
                                int nlay, int noffsets, int parts,
                                void* stream) {
    int (*fn)(const float*, const int*, const float*, const int*, float*,
              float*, int, int, int, void*);
    switch (parts) {
        case ALL: fn = run<ALL>; break;
        case MAJOR | MINOR | PLANCK: fn = run<MAJOR | MINOR | PLANCK>; break;
        case MAJOR | CONT | PLANCK: fn = run<MAJOR | CONT | PLANCK>; break;
        case MAJOR | MINOR | CONT: fn = run<MAJOR | MINOR | CONT>; break;
        case MAJOR: fn = run<MAJOR>; break;
        case MINOR: fn = run<MINOR>; break;
        case 0: fn = run<0>; break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return fn(fplanes, iplanes, pack, offsets, taug, pfracs, ncol, nlay,
              noffsets, stream);
}
