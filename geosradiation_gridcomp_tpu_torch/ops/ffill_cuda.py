"""Forward fill down the layer axis (kernel P1) and its plain twin.

Replaces the TPU micro-kernel tools/profiling/fused_mcica_check.py:
ffill_host, the McICA overlap fill of the fused kernel
(geosradiation_gridcomp_tpu/ops/mcica_pallas.py:_ffill) run alone, with a
CUDA kernel (csrc/ffill.cu). Arrays are [B, nlay, nsub], layers on the
second axis, as _ffill documents. The reference tool fed _ffill
[B, nsub, nlay] arrays and so filled along the subcolumn axis (ROADMAP,
Queue 3); this fill follows the layer axis, which is what the overlap
chain of ops/mcica.py:_correlate fills.
"""

import torch

from ..kernels import build
from ..kernels.twins import use_kernel
from .mcica import _correlate


def ffill_plain(v, keep):
    """Plain twin of P1: ops.mcica._correlate on the transposed layout.

    v, keep: [..., nlay, nsub] float32; a cell keeps its own value where
    keep != 0, else takes the filled value of the layer above; layer 0
    always keeps its own. Returns [..., nlay, nsub].
    """
    return _correlate(v.transpose(-1, -2),
                      keep.transpose(-1, -2) != 0).transpose(-1, -2) \
        .contiguous()


def launch(lib, v, keep):
    """Allocate the output and launch P1 from lib; returns it."""
    nb, nlay, nsub = v.shape
    out = torch.empty_like(v)
    fn = build.entry(lib, "ffill", 3, 3)
    rc = fn(v.data_ptr(), keep.data_ptr(), out.data_ptr(), nb, nlay, nsub,
            build.stream_of(v))
    build.check(rc, "ffill")
    return out


def ffill(v, keep):
    """P1: same contract as ffill_plain, for [B, nlay, nsub] arrays.

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    """
    if not use_kernel(v):
        return ffill_plain(v, keep)
    build.require_cuda("ffill", v, keep)
    if v.dim() != 3 or keep.shape != v.shape:
        raise ValueError("ffill: v and keep must both be [B, nlay, nsub]")
    if v.dtype != torch.float32 or keep.dtype != torch.float32:
        raise TypeError("ffill: v and keep must be float32")
    out = launch(build.library(), v, keep)
    build.LAUNCHES["ffill"] += 1
    return out
