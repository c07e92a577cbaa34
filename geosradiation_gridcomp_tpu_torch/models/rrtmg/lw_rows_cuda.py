"""The LW table rows: kernel K9 (csrc/lw_rows.cu) and its two launches.

K9 computes on the card what cldprmc_lw.band_abs_coeffs_lw (the cloud
rows: absice, absliq) and setcoef_lw.planck_rows_plain (the Planck rows:
planklay, planklev, plankbnd, dplankbnd), its plain twins, compute in
plain PyTorch, bit for bit: the factor, its floor clamped to the table,
the weight and the interpolation of the two rows, in one pass that writes
each output row once, where the twins gather the rows and run each step
as a pass of its own. band_abs_coeffs_lw and setcoef_lw call it where
kernels.twins.use_kernel.

The ice factor (reice - 2) / 3 is rounded as PyTorch rounds the twin's on
the card: a CUDA tensor divided by a Python number is multiplied by the
number's float reciprocal (ATen's div_true_kernel_cuda), so K9 multiplies
by float(1/3). (A CPU tensor is divided, so the emulated kernel's ice rows
differ from the twin's on the CPU by an ulp of the factor here and there.)
"""

import torch

from ...kernels import build

NBND = 16
PLANCK_ROWS = 181     # totplnk / totplnkderiv: 160..340 K by 1 K
# points of one segment, so that the kernel's 32-bit float4 offsets fit
MAX_POINTS = (2**31 - 1) // 4 - 256


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_cloud(lib, reice, reliq, ice_tab, liq_tab):
    """Allocate the outputs and launch K9's cloud rows from lib: absice
    (None where reice is None) and absliq, each reliq.shape + (16,)."""
    dev = reliq.device
    absliq = torch.empty(reliq.shape + (NBND,), dtype=torch.float32,
                         device=dev)
    absice = None if reice is None else torch.empty_like(absliq)
    fn = build.entry(lib, "lw_rows_cloud", 6, 3)
    ice_tab = None if reice is None else ice_tab
    rc = fn(_ptr(reice), reliq.data_ptr(), _ptr(ice_tab), liq_tab.data_ptr(),
            _ptr(absice), absliq.data_ptr(), reliq.numel(),
            0 if ice_tab is None else ice_tab.shape[0], liq_tab.shape[0],
            build.stream_of(reliq))
    build.check(rc, "lw_rows_cloud")
    return absice, absliq


def launch_planck(lib, tavel, tz, tbound, semiss, totplnk, totplnkderiv,
                  dudts=True):
    """Allocate the outputs and launch K9's Planck rows from lib; returns
    (plankbnd, dplankbnd, planklay, planklev), dplankbnd zeros unless
    dudts."""
    dev = tavel.device
    rows = lambda x: torch.empty(x.shape + (NBND,), dtype=torch.float32,
                                 device=dev)
    planklay, planklev, plankbnd = rows(tavel), rows(tz), rows(tbound)
    dplankbnd = rows(tbound) if dudts else torch.zeros_like(plankbnd)
    fn = build.entry(lib, "lw_rows_planck", 10, 4)
    rc = fn(tavel.data_ptr(), tz.data_ptr(), tbound.data_ptr(),
            semiss.data_ptr(), totplnk.data_ptr(),
            totplnkderiv.data_ptr() if dudts else None, planklay.data_ptr(),
            planklev.data_ptr(), plankbnd.data_ptr(),
            dplankbnd.data_ptr() if dudts else None, tavel.numel(),
            tz.numel(), tbound.numel(), totplnk.shape[0],
            build.stream_of(tavel))
    build.check(rc, "lw_rows_planck")
    return plankbnd, dplankbnd, planklay, planklev


def _require(name, points, tensors, tables, rows=()):
    """Refuse what the kernel does not take: tensors off one CUDA device,
    not contiguous or not float32, tables not [rows >= 2, 16], more
    points than 32-bit offsets reach, and rows read as float4 (the
    tables and `rows`) not 16-byte aligned."""
    build.require_cuda(name, *tensors, *tables)
    if any(t.dtype != torch.float32 for t in (*tensors, *tables)):
        raise TypeError(f"{name}: inputs and tables must be float32")
    for t in tables:
        if t.dim() != 2 or t.shape[1] != NBND or t.shape[0] < 2:
            raise ValueError(f"{name}: a table must be [rows >= 2, {NBND}], "
                             f"got {tuple(t.shape)}")
    if any(t.data_ptr() % 16 for t in (*tables, *rows)):
        raise ValueError(f"{name}: tables and semiss must be 16-byte "
                         f"aligned")
    if any(t.numel() > MAX_POINTS for t in points):
        raise ValueError(f"{name}: at most {MAX_POINTS} points a segment")


def cloud_rows(reice, reliq, ice_tab, liq_tab):
    """K9, cloud: band_abs_coeffs_lw's absice and absliq [..., nlay, 16]
    from reice / reliq [..., nlay] (microns) and the ice table of the
    iceflag ([n, 16]: absice2, absice3 or absice4) and absliq1 ([58, 16]).
    reice and ice_tab None: absliq alone (iceflags 0 and 1, whose ice
    coefficients have no row table); absice is then None.

    All on one CUDA device, float32, contiguous, reice and reliq of one
    shape. Launches once, on the current stream, without a sync.
    """
    ice = () if reice is None else (reice,)
    tabs = (liq_tab,) if reice is None else (ice_tab, liq_tab)
    _require("lw_rows_cloud", (reliq,), (*ice, reliq), tabs)
    if reice is not None and reice.shape != reliq.shape:
        raise ValueError("lw_rows_cloud: reice and reliq must have one "
                         f"shape, got {tuple(reice.shape)} and "
                         f"{tuple(reliq.shape)}")
    out = launch_cloud(build.library(), reice, reliq, ice_tab, liq_tab)
    build.LAUNCHES["lw_rows"] += 1
    return out


def planck_rows(tavel, tz, tbound, semiss, totplnk, totplnkderiv,
                dudts=True):
    """K9, Planck: setcoef_lw's (plankbnd, dplankbnd, planklay, planklev)
    from tavel [..., nlay], tz [..., nlay + 1], tbound [...] (K), semiss
    [..., 16] and the (181, 16) tables totplnk and totplnkderiv;
    dplankbnd zeros unless dudts.

    All on one CUDA device, float32, contiguous. Launches once, on the
    current stream, without a sync.
    """
    _require("lw_rows_planck", (tavel, tz, tbound),
             (tavel, tz, tbound, semiss), (totplnk, totplnkderiv), (semiss,))
    lead = tbound.shape
    if (tavel.shape[:-1] != lead or tz.shape[:-1] != lead
            or tz.shape[-1] != tavel.shape[-1] + 1
            or semiss.shape != lead + (NBND,)):
        raise ValueError(
            "lw_rows_planck: want tavel [..., nlay], tz [..., nlay + 1], "
            f"tbound [...], semiss [..., {NBND}], got {tuple(tavel.shape)}, "
            f"{tuple(tz.shape)}, {tuple(tbound.shape)}, "
            f"{tuple(semiss.shape)}")
    if any(t.shape[0] != PLANCK_ROWS for t in (totplnk, totplnkderiv)):
        raise ValueError(f"lw_rows_planck: the Planck tables must be "
                         f"({PLANCK_ROWS}, {NBND})")
    out = launch_planck(build.library(), tavel, tz, tbound, semiss, totplnk,
                        totplnkderiv, dudts)
    build.LAUNCHES["lw_rows"] += 1
    return out
