"""LW gas optical depth and Planck fractions (kernel K3), its cost
bisection (kernel P3) and their plain twins.

K3 replaces the TPU kernel geosradiation_gridcomp_tpu/models/rrtmg/
taumol_lw_pallas.py:taumol_lw_fast with a CUDA kernel (csrc/taumol_lw.cu)
that evaluates the per-band reference engine (taumol_lw_ref) for a tile
of 32 columns at one layer per block, each warp two bands and one lane
per column: the band's lower or upper formula, looped over its g-points,
reading the packed k-distribution of TaumolTables; the tile's rows of
both outputs are assembled in shared memory and written as contiguous
16-byte stores. P3 replaces
the reference's profiling kernel tools/profiling/taumol_lw_bisect.py:make:
K3's body (csrc/taumol_lw.cuh) compiled with parts left out
(csrc/taumol_lw_bisect.cu), one variant per entry of VARIANTS.
"""

import numpy as np
import torch

from ...kernels import build
from ...kernels.twins import use_kernel
from .taumol_lw import BAND_KEYS, GLOBAL_KEYS, PARTS, taumol_lw

# per-cell inputs, in the row order of the kernel's float and int planes
FLOAT_FIELDS = ("fac00", "fac01", "fac10", "fac11", "selffac", "selffrac",
                "forfac", "forfrac", "minorfrac", "scaleminor",
                "scaleminorn2", "coldry", "colbrd", "colh2o", "colco2",
                "colo3", "coln2o", "colch4", "colo2", "colco", "colcfc11",
                "colcfc12", "colcfc22", "colccl4", "pavel")
INT_FIELDS = ("lower", "jp", "jt", "jt1", "indself", "indfor", "indminor")
N_OFFSETS = 16 * len(BAND_KEYS) + len(GLOBAL_KEYS)
# the kernel's part bits (csrc/taumol_lw.cuh: Part)
PART_BITS = {"major": 1, "minor": 2, "cont": 4, "planck": 8}


def _planes(coefs):
    """The per-cell float and int planes the kernel reads, the output
    shape [*cells, 140] and the cells as (ncol, nlay): the last axis is
    the layer (a flat cell axis counts as one layer)."""
    shape = coefs.jp.shape
    ncells = int(np.prod(shape))
    nlay = shape[-1] if len(shape) > 1 else 1
    fplanes = torch.stack([getattr(coefs, k).reshape(ncells)
                           for k in FLOAT_FIELDS]).contiguous()
    iplanes = torch.stack([getattr(coefs, k).reshape(ncells).to(torch.int32)
                           for k in INT_FIELDS]).contiguous()
    return fplanes, iplanes, shape + (140,), (ncells // nlay, nlay)


def launch(lib, coefs, tabs, taua=None):
    """Stack the per-cell fields, allocate the outputs and launch K3 from
    lib; returns (taug, pfracs) [*cells, 140]."""
    fplanes, iplanes, shape, (ncol, nlay) = _planes(coefs)
    ncells = fplanes.shape[1]
    taug = torch.empty(shape, dtype=torch.float32, device=fplanes.device)
    pfracs = torch.empty_like(taug)
    ta = None if taua is None else taua.reshape(ncells, 16).contiguous()
    fn = build.entry(lib, "taumol_lw", 7, 3)
    rc = fn(fplanes.data_ptr(), iplanes.data_ptr(), tabs.pack.data_ptr(),
            tabs.offsets.data_ptr(), None if ta is None else ta.data_ptr(),
            taug.data_ptr(), pfracs.data_ptr(), ncol, nlay, N_OFFSETS,
            build.stream_of(fplanes))
    build.check(rc, "taumol_lw")
    return taug, pfracs


def launch_bisect(lib, coefs, tabs, parts):
    """Launch the P3 variant computing `parts` from lib; returns (taug,
    pfracs) [*cells, 140]."""
    fplanes, iplanes, shape, (ncol, nlay) = _planes(coefs)
    taug = torch.empty(shape, dtype=torch.float32, device=fplanes.device)
    pfracs = torch.empty_like(taug)
    fn = build.entry(lib, "taumol_lw_bisect", 6, 4)
    rc = fn(fplanes.data_ptr(), iplanes.data_ptr(), tabs.pack.data_ptr(),
            tabs.offsets.data_ptr(), taug.data_ptr(), pfracs.data_ptr(),
            ncol, nlay, N_OFFSETS,
            sum(PART_BITS[p] for p in parts), build.stream_of(fplanes))
    build.check(rc, "taumol_lw_bisect")
    return taug, pfracs


def _require(name, coefs, tabs, taua=None):
    fields = [getattr(coefs, k) for k in FLOAT_FIELDS + INT_FIELDS]
    build.require_cuda(name, tabs.pack, tabs.offsets,
                       *[t.contiguous() for t in fields],
                       *([] if taua is None else [taua.contiguous()]))
    for k in FLOAT_FIELDS:
        if getattr(coefs, k).dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32")
    if tabs.offsets.dtype != torch.int32 or tabs.offsets.numel() != N_OFFSETS:
        raise ValueError(f"{name}: offsets must be int32 [{N_OFFSETS}]")


def taumol_lw_fast(coefs, tabs, taua=None):
    """K3: same contract as taumol_lw.taumol_lw.

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    """
    if not use_kernel(coefs.jp):
        return taumol_lw(coefs, tabs, taua)
    _require("taumol_lw_fast", coefs, tabs, taua)
    if taua is not None and taua.shape != coefs.jp.shape + (16,):
        raise ValueError("taumol_lw_fast: taua must be [..., nlay, 16]")
    out = launch(build.library(), coefs, tabs, taua)
    build.LAUNCHES["taumol_lw"] += 1
    return out


def taumol_lw_bisect(coefs, tabs, parts):
    """P3: taumol_lw with only `parts` computed (a subset of
    taumol_lw.PARTS; the others contribute zeros), for the cost bisection.
    Only the subsets of taumol_lw.VARIANTS are compiled.

    The plain twin (taumol_lw with parts) unless kernels.twins.use_kernel;
    then the kernel. Returns (taug, pfracs) [ncol, nlay, 140].
    """
    parts = frozenset(parts)
    if not parts <= PARTS:
        raise ValueError(f"taumol_lw_bisect: unknown parts {parts - PARTS}")
    if not use_kernel(coefs.jp):
        return taumol_lw(coefs, tabs, parts=parts)
    _require("taumol_lw_bisect", coefs, tabs)
    out = launch_bisect(build.library(), coefs, tabs, parts)
    build.LAUNCHES["taumol_lw_bisect"] += 1
    return out
