"""RRTMGP's McICA draws: kernel K8 (csrc/mcica_gmr.cu) and its launch.

K8 computes on the card what models/rrtmgp/scheme.py:_gen_max_ran_mask,
its plain twin, computes in plain PyTorch, bit for bit: per column the
state key (ops.mcica.state_seed_key, derived in the kernel's prologue
from play), per (column, g-point) the (4, ngpt, nlay) threefry uniforms
of that key drawn on the fly, both generalised max-random chains down
the layers, the cloud mask and the zcw condensate scaling from the class
table. Only the mask and zcw touch memory. _gen_max_ran_mask calls it for
CUDA tensors unless plain.
"""

import torch

from ..kernels import build


def launch(lib, play, alpha, rcorr, cldf, ngpt, zcw_cols):
    """Allocate the outputs and launch K8 from lib; returns cld_mask bool
    and zcw float32, each [ncol, nlay, ngpt]."""
    ncol, nlay = cldf.shape
    dev = cldf.device
    mask = torch.empty((ncol, nlay, ngpt), dtype=torch.bool, device=dev)
    zcw = torch.empty((ncol, nlay, ngpt), dtype=torch.float32, device=dev)
    fn = build.entry(lib, "mcica_gmr", 7, 4)
    rc = fn(play.data_ptr(), alpha.data_ptr(), rcorr.data_ptr(),
            cldf.data_ptr(), None if zcw_cols is None else zcw_cols.data_ptr(),
            mask.data_ptr(), zcw.data_ptr(), ncol, nlay, ngpt,
            int(zcw_cols is not None), build.stream_of(cldf))
    build.check(rc, "mcica_gmr")
    return mask, zcw


def gen_max_ran_mask(play, alpha, rcorr, cldf, ngpt, zcw_cols):
    """K8: the GEN_MAX_RAN_OVERLAP cloud mask and zcw of ngpt g-points.

    play (hPa, TOA first), alpha, rcorr (ops.mcica.overlap_params, layer 0
    = 0) and cldf: [ncol, nlay] float32 on one CUDA device, contiguous,
    nlay >= 4; zcw_cols: the (3, 1000) float32 class columns, or None for
    none (inhm 0: zcw = 1 where cloudy). Returns cld_mask bool and zcw
    float32 (0 where clear), each [ncol, nlay, ngpt].
    """
    tables = () if zcw_cols is None else (zcw_cols,)
    build.require_cuda("mcica_gmr", play, alpha, rcorr, cldf, *tables)
    if any(t.dtype != torch.float32
           for t in (play, alpha, rcorr, cldf, *tables)):
        raise TypeError("mcica_gmr: inputs must be float32")
    if cldf.dim() != 2 or cldf.shape[1] < 4 or any(
            t.shape != cldf.shape for t in (play, alpha, rcorr)):
        raise ValueError("mcica_gmr: play, alpha, rcorr and cldf must all "
                         "be [ncol, nlay] with nlay >= 4")
    if zcw_cols is not None and zcw_cols.shape != (3, 1000):
        raise ValueError("mcica_gmr: zcw_cols must be (3, 1000)")
    out = launch(build.library(), play, alpha, rcorr, cldf, ngpt, zcw_cols)
    build.LAUNCHES["mcica_gmr"] += 1
    return out
