"""Table-gather micro-kernels (P2: gather_rows, gather_lanes) and their
plain twins.

Replace the TPU micro-kernels tools/profiling/gather_micro.py:
pallas_gather and pallas_gather2 with CUDA kernels (csrc/gather_micro.cu).
They time the primitive at the core of the taumol kernels and of the
table-row gathers of setcoef and the cloud band coefficients: rows of a
small table at N = ncol x nlay indices. Only the profiling tool
tools/profiling/gather_micro.py calls them.
"""

import ctypes

import torch

from ..kernels import build
from ..kernels.twins import use_kernel

LANES = 128
BLOCK_ROWS = 64    # index rows per output block of gather_lanes

# The cases of gather_rows' contract that the tests and chip_smoke.py hold
# against the twin: name -> (points, table rows, ng, lowest index, highest
# index + 1, the table's offset in floats from an aligned allocation).
ROWS_CASES = {
    "tool": (8192, 585, 16, 0, 585, 0),        # the tool's table, float4
    "ragged": (8191, 585, 16, 0, 585, 0),      # a part-full last block
    "ng14": (8192, 585, 14, 0, 585, 0),        # the SW band count, float2
    "ng5": (4099, 585, 5, 0, 585, 0),          # an odd width, float
    "unaligned": (8192, 585, 16, 0, 585, 1),   # a table off 16 B, float
    "clamped": (8192, 585, 16, -700, 1300, 0),  # indices outside the table
    "large_table": (8192, 5000, 16, 0, 5000, 0),  # 320 KB, beyond an L1
    "wide": (1000, 50, 1100, 0, 50, 0),        # 275 float4 a row: q loops
    "absliq1": (8192, 58, 16, 0, 58, 0),       # the refresh's LW cloud
    "absice3": (8192, 46, 16, 0, 46, 0),       # tables (cldprmc_lw.py)
}


def gather_rows_plain(idx, tab):
    """Plain twin of gather_rows: tab[idx] with idx clamped to the table.
    idx [N] int32, tab [rows, ng] float32 -> [N, ng]."""
    return tab[idx.long().clamp(0, tab.shape[0] - 1)]


def gather_lanes_plain(idx2d, tabT):
    """Plain twin of gather_lanes: tabT[:, idx] in the block layout of the
    reference's pallas_gather2. idx2d [nrows, 128] int32 (nrows a multiple
    of 64), tabT [ng, width] float32 -> [nrows * ng, 128], where for the
    k-th block of 64 index rows, row (k * ng + g) * 64 + r holds
    tabT[g, idx2d[k * 64 + r]]."""
    nrows = idx2d.shape[0]
    ng = tabT.shape[0]
    g = tabT[:, idx2d.reshape(nrows // BLOCK_ROWS, BLOCK_ROWS, LANES).long()]
    return g.transpose(0, 1).reshape(nrows * ng, LANES)


def launch_rows(lib, idx, tab):
    """Allocate the output and launch gather_rows from lib."""
    rows, ng = tab.shape
    out = torch.empty((idx.shape[0], ng), dtype=torch.float32,
                      device=tab.device)
    fn = build.entry(lib, "gather_rows", 3, 3)
    rc = fn(idx.data_ptr(), tab.data_ptr(), out.data_ptr(), idx.shape[0],
            rows, ng, build.stream_of(tab))
    build.check(rc, "gather_rows")
    return out


def rows_vec(tab, out, lib=None):
    """The floats a thread of gather_rows moves at once for these tensors:
    4, 2 or 1, the kernel's template instance (by ng and alignment)."""
    fn = (lib or build.library()).gather_rows_vec
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tab.data_ptr(), out.data_ptr(), tab.shape[1])


def launch_lanes(lib, idx2d, tabT):
    """Allocate the output and launch gather_lanes from lib."""
    ng, width = tabT.shape
    nrows = idx2d.shape[0]
    out = torch.empty((nrows * ng, LANES), dtype=torch.float32,
                      device=tabT.device)
    fn = build.entry(lib, "gather_lanes", 3, 3)
    rc = fn(idx2d.data_ptr(), tabT.data_ptr(), out.data_ptr(), nrows, width,
            ng, build.stream_of(tabT))
    build.check(rc, "gather_lanes")
    return out


def _require(name, idx, tab):
    build.require_cuda(name, idx, tab)
    if idx.dtype != torch.int32 or tab.dtype != torch.float32 \
            or tab.dim() != 2:
        raise TypeError(f"{name}: idx must be int32, the table 2-D float32")


def gather_rows(idx, tab):
    """P2, rows: tab[idx], indices clamped to the table; any N, rows and
    ng. Each thread stores a vector of rows_vec floats (float4 where ng is
    a multiple of 4), the table read through the read-only path.

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    """
    if not use_kernel(tab):
        return gather_rows_plain(idx, tab)
    _require("gather_rows", idx, tab)
    if idx.dim() != 1:
        raise ValueError("gather_rows: idx must be [N]")
    out = launch_rows(build.library(), idx, tab)
    build.LAUNCHES["gather_rows"] += 1
    return out


def gather_lanes(idx2d, tabT):
    """P2, lanes: the pallas_gather2 contract (see gather_lanes_plain),
    with tabT resident in shared memory (at most 48 KB).

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    Indices must lie in [0, width) (the kernel clamps them to the table).
    """
    if not use_kernel(tabT):
        return gather_lanes_plain(idx2d, tabT)
    _require("gather_lanes", idx2d, tabT)
    if idx2d.dim() != 2 or idx2d.shape[1] != LANES \
            or idx2d.shape[0] % BLOCK_ROWS:
        raise ValueError("gather_lanes: idx must be [64 k, 128]")
    if tabT.numel() * 4 > 48 * 1024:
        raise ValueError("gather_lanes: the table must fit in 48 KB")
    out = launch_lanes(build.library(), idx2d, tabT)
    build.LAUNCHES["gather_lanes"] += 1
    return out
