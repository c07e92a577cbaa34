"""SW gas and Rayleigh optical depths (kernel K5) and its plain twin.

Replaces the TPU kernel geosradiation_gridcomp_tpu/models/rrtmg/
taumol_sw_pallas.py:taumol_sw_pallas with a CUDA kernel (csrc/taumol_sw.cu)
that evaluates the per-band reference engine (taumol_sw_ref) one thread
per (cell, band): the band's lower or upper formula, looped over its
g-points, reading the packed k-distribution of TaumolTables. The solar
source stays in plain PyTorch (taumol_sw.sfluxzen_only).
"""

import numpy as np
import torch

from ...kernels import build
from .taumol_sw import BAND_KEYS, taumol_sw

# per-cell inputs, in the row order of the kernel's float and int planes
FLOAT_FIELDS = ("fac00", "fac01", "fac10", "fac11", "selffac", "selffrac",
                "forfac", "forfrac", "colh2o", "colco2", "colo3", "colch4",
                "colo2", "colmol")
INT_FIELDS = ("lower", "jp", "jt", "jt1", "indself", "indfor")
N_OFFSETS = 2 * 14 * len(BAND_KEYS)


def launch(lib, coefs, tabs):
    """Stack the per-cell fields, allocate the outputs and launch K5 from
    lib; returns (taug, taur) [*cells, 112]."""
    shape = coefs.jp.shape
    ncells = int(np.prod(shape))
    dev = coefs.jp.device
    fplanes = torch.stack([getattr(coefs, k).reshape(ncells)
                           for k in FLOAT_FIELDS]).contiguous()
    iplanes = torch.stack([getattr(coefs, k).reshape(ncells).to(torch.int32)
                           for k in INT_FIELDS]).contiguous()
    taug = torch.empty(shape + (112,), dtype=torch.float32, device=dev)
    taur = torch.empty(shape + (112,), dtype=torch.float32, device=dev)
    fn = build.entry(lib, "taumol_sw", 6, 2)
    rc = fn(fplanes.data_ptr(), iplanes.data_ptr(), tabs.pack.data_ptr(),
            tabs.offsets.data_ptr(), taug.data_ptr(), taur.data_ptr(),
            ncells, N_OFFSETS, build.stream_of(fplanes))
    build.check(rc, "taumol_sw")
    return taug, taur


def taumol_sw_fast(coefs, tabs):
    """K5: same contract as taumol_sw.taumol_sw.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if coefs.jp.device.type == "cpu":
        return taumol_sw(coefs, tabs)
    fields = [getattr(coefs, k) for k in FLOAT_FIELDS + INT_FIELDS]
    build.require_cuda("taumol_sw_fast", tabs.pack, tabs.offsets,
                       *[t.contiguous() for t in fields])
    for k in FLOAT_FIELDS:
        if getattr(coefs, k).dtype != torch.float32:
            raise TypeError(f"taumol_sw_fast: {k} must be float32")
    if tabs.offsets.dtype != torch.int32 or tabs.offsets.numel() != N_OFFSETS:
        raise ValueError("taumol_sw_fast: offsets must be int32 "
                         f"[{N_OFFSETS}]")
    out = launch(build.library(), coefs, tabs)
    build.LAUNCHES["taumol_sw"] += 1
    return out
