"""QuickBeam's DSD integrals, path integral and dBZe: kernel K11
(csrc/quickbeam.cu).

K11 computes on the card, in one launch over every point, what the plain
twin (radar.py:_quickbeam_block over the points in blocks) computes: each
present class's N(D) at the 85 sizes, the trapezoid integrals of its
reflectivity and attenuation (and Rayleigh reflectivity), summed over the
classes; the hydrometeor path from the top down; dbze, ze_non and h_atten
(and ze_ray). No [points, subcolumns, levels, 85] plane is written: the
integral is linear in N(D), so each trapezoid is a weighted sum whose
weights (class_tables) fold the grid's widths, d^2 or d^6, the unit
factors, each class's static factor of D and the Mie efficiencies at
every temperature row. The gas path (radar.gas_path) stays in PyTorch,
as in the twin. radar.quickbeam_simulator launches K11 where
kernels.twins.use_kernel holds and runs the twin otherwise.
"""

import functools
import math

import numpy as np
import torch

from ..kernels import build
from ..tables import on_device
from . import radar as qb

# the kernel's limits: the GEOS table's classes, levels; parameters a class
MAX_CLASSES = 9
MAX_LEVELS = 256
NPRM = 9


def _widths(d_m):
    """Trapezoid weights of a grid (float32, as the twin's): sum_k w_k y_k
    is the twin's trapezoid of y, its differences rounded as the twin's."""
    dx = (d_m[1:] - d_m[:-1]).double()
    w = torch.zeros(d_m.shape, dtype=torch.float64)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


@functools.lru_cache(maxsize=None)
def class_tables(classes):
    """K11's per-class tables for a tuple of rows of the GEOS class table,
    as numpy float32: weights [nclass, ntemp, 85, 4] and parameters
    [nclass, NPRM] (csrc/quickbeam.cu). Per (class, temperature row, size)
    the weights are the z weight (backscatter x d^2 x 0.25 pi 1e18), the
    attenuation weight (extinction x d^2 x 0.25 pi 1000 x 10 / ln 10), the
    size's abscissa x_k (D_k in um; for the lognormal log D_k less the
    log of its default 2 rg, so that x_k is small where N(D) peaks) and
    the Rayleigh weight (d^6 x 1e18), each with the grid's trapezoid width,
    1e12 (N(D) in SI) and the class's static factor of D. The grid, the
    ice classes' D_eq and their interpolated efficiencies are formed as
    the twin forms them, in float32 (radar._quickbeam_block); the weights
    from them in float64, rounded once."""
    hc = qb.hclass()
    tabs = [torch.as_tensor(t) for t in qb.mie_tables()]
    D = torch.as_tensor(qb.D_GRID_UM, dtype=torch.float32)
    logd = torch.log(D)
    ntemp = max(len(qb.T_GRID_LIQ), len(qb.T_GRID_ICE))
    wt = torch.zeros((len(classes), ntemp, qb.ND, 4), dtype=torch.float64)
    prm = torch.zeros((len(classes), NPRM), dtype=torch.float64)
    cr = 10.0 / np.log(10.0)
    d64 = torch.as_tensor(qb.D_GRID_UM)
    for i, tp in enumerate(classes):
        form, phase = int(hc["type"][tp]), int(hc["phase"][tp])
        apm, bpm, rho_c = (float(hc[k][tp]) for k in ("apm", "bpm", "rho"))
        p1, p2, p3 = (float(hc[k][tp]) for k in ("p1", "p2", "p3"))
        if rho_c > 0 and apm < 0:
            apm, bpm = (np.pi / 6.0) * rho_c, 3.0
        if form == 1:
            vu = p3
            static = (d64 * 1e-6) ** (vu - 1.0)
            x = d64
            prm[i, 3:8] = torch.tensor((
                math.gamma(vu + 2.0), math.gamma(vu + 3.0),
                math.gamma(vu) / math.gamma(vu + 1.0) * p2, vu + bpm,
                1e-15 / (apm * math.gamma(vu + bpm))))
        elif form == 2:
            static = torch.full_like(d64, p1 * 1e-12)
            x = d64
            prm[i, 3:5] = torch.tensor((apm * math.gamma(1.0 + bpm) * p1,
                                        1.0 / (1.0 + bpm)))
        elif form == 5:
            sg, centre = p3, math.log(2.0 * p2)
            static = 1.0 / d64
            x = torch.log(d64) - centre
            prm[i, 3:9] = torch.tensor((
                np.exp(-2.5 * sg ** 2), p2, bpm, -0.5 / sg ** 2,
                0.5e-15 * np.exp(-0.5 * (bpm * sg) ** 2)
                / (apm * np.sqrt(2.0 * np.pi) * sg * 0.5e-6),
                2.0 * math.exp(-centre)))
        else:
            raise NotImplementedError(f"dsd type {form}")
        if phase == 1:
            # equivalent-volume solid-ice spheres, their efficiencies
            # interpolated at D_eq on the D grid, as the twin's
            if rho_c < 0:
                deq = ((6.0 / np.pi * apm / qb.RHO_ICE) ** (1.0 / 3.0)
                       * (D * 1e-6) ** (bpm / 3.0)) * 1e6
            else:
                deq = D * (rho_c / qb.RHO_ICE) ** (1.0 / 3.0)
            pos = torch.clamp((torch.log(deq) - logd[0])
                              / (logd[1] - logd[0]), 0, qb.ND - 1)
            i0 = torch.clamp(pos.to(torch.int32), 0, qb.ND - 2).long()
            w = pos - i0
            qe, qbs = ((1 - w) * t[:, i0] + w * t[:, i0 + 1]
                       for t in tabs[2:])
            d_int, t_grid = deq, qb.T_GRID_ICE
        else:
            qe, qbs = tabs[:2]
            d_int, t_grid = D, qb.T_GRID_LIQ
        d_m = d_int * 1e-6
        base = 1e12 * _widths(d_m) * static
        d2, d6 = (d_m ** 2).double(), (d_m ** 6).double()
        nt = len(t_grid)
        wt[i, :nt, :, 0] = qbs.double() * (base * d2 * 0.25 * np.pi * 1e18)
        wt[i, :nt, :, 1] = qe.double() * (base * d2 * 0.25 * np.pi * 1000.0
                                          * cr)
        wt[i, :, :, 2] = x
        wt[i, :, :, 3] = base * d6 * 1e18
        prm[i, :3] = torch.tensor((form, t_grid[0], nt - 1))
    return (wt.to(torch.float32).numpy(), prm.to(torch.float32).numpy())


@functools.lru_cache(maxsize=None)
def _device_tables(classes, device):
    """class_tables on the device, looked up without hashing their bytes
    again on every call."""
    return tuple(on_device(a, device) for a in class_tables(classes))


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(lib, hgt_km, p_hpa, t_c, hm_gkg, re_um, gas, classes, k2,
           do_ray):
    """Allocate the outputs and the counter and launch K11 from lib; gas is
    the gas path [np, nlev] or None. Returns ([dbze, ze_non, h_atten and
    with do_ray ze_ray], each [np, ncol, nlev]; the counter, an int32
    tensor [1] of the (volume, class) pairs K11 integrated)."""
    ncls, npnt, ncol, nlev = hm_gkg.shape
    dev = hm_gkg.device
    wt, prm = _device_tables(classes, dev)
    out = [torch.empty((npnt, ncol, nlev), dtype=torch.float32, device=dev)
           for _ in range(4 if do_ray else 3)]
    present = torch.zeros(1, dtype=torch.int32, device=dev)
    wl_m = 2.99792458 / (qb.FREQ_GHZ * 10.0)
    outs = [x.data_ptr() for x in out] + [None] * (4 - len(out))
    fn = build.entry(lib, "quickbeam", 13, 5, 1)
    rc = fn(hm_gkg.data_ptr(), re_um.data_ptr(), hgt_km.data_ptr(),
            p_hpa.data_ptr(), t_c.data_ptr(), _ptr(gas), wt.data_ptr(),
            prm.data_ptr(), *outs, present.data_ptr(), ncls, npnt, ncol,
            nlev, wt.shape[1], (wl_m ** 4 / np.pi ** 5) / k2,
            build.stream_of(hm_gkg))
    build.check(rc, "quickbeam")
    return out, present


def simulate(lib, hgt_km, p_hpa, t_c, rh, hm_gkg, re_um, classes, k2,
             do_ray, use_gas_abs):
    """quickbeam_simulator's result through K11 from lib, the gas path in
    PyTorch, in the twin's keys, order and shapes; records radar.counts():
    one block of every point, no plane, and the counter."""
    npnt = hm_gkg.shape[1]
    gas = qb.gas_path(hgt_km, p_hpa, t_c, rh) if use_gas_abs else None
    out, present = launch(lib, hgt_km, p_hpa, t_c, hm_gkg, re_um,
                          None if gas is None else gas[:, 0], classes, k2,
                          do_ray)
    res = dict(dbze=out[0], ze_non=out[1], h_atten=out[2],
               g_atten=gas if use_gas_abs else torch.zeros_like(out[0]))
    if do_ray:
        res["ze_ray"] = out[3]
    qb._COUNTS[(classes, tuple(hm_gkg.shape[1:]), str(hm_gkg.dtype))] = dict(
        blocks=1, points_per_block=npnt, classes=len(classes), points=npnt,
        plane_bytes=0, kernel=True, present=present)
    return res


def quickbeam_kernel(hgt_km, p_hpa, t_c, rh, hm_gkg, re_um, classes,
                     k2=qb.K2_94, do_ray=False, use_gas_abs=True):
    """K11 itself: quickbeam_simulator's contract on float32 tensors of one
    CUDA device, contiguous: the profiles [np, nlev], hm_gkg and re_um
    [nclass, np, ncol, nlev], nclass <= MAX_CLASSES, nlev <= MAX_LEVELS,
    classes a tuple of as many rows of the class table. Raises on anything
    else. Launches once, on the current stream, without a sync."""
    ins = (hgt_km, p_hpa, t_c, rh, hm_gkg, re_um)
    if any(x.dtype != torch.float32 for x in ins):
        raise TypeError("quickbeam: inputs must be float32")
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("quickbeam: tensors must be contiguous")
    if hm_gkg.dim() != 4 or re_um.shape != hm_gkg.shape:
        raise ValueError(f"quickbeam: hm and re must be [nclass, np, ncol, "
                         f"nlev], got {tuple(hm_gkg.shape)} and "
                         f"{tuple(re_um.shape)}")
    ncls, npnt, ncol, nlev = hm_gkg.shape
    if not 1 <= ncls <= MAX_CLASSES or len(classes) != ncls:
        raise ValueError(f"quickbeam: {ncls} classes for {len(classes)} "
                         f"rows: the kernel takes 1 to {MAX_CLASSES}")
    if any(x.shape != (npnt, nlev) for x in ins[:4]):
        raise ValueError("quickbeam: the profiles must be [np, nlev]")
    if nlev > MAX_LEVELS:
        raise ValueError(f"quickbeam: {nlev} levels: the kernel takes at most "
                         f"{MAX_LEVELS}")
    if ncls * hm_gkg[0].numel() >= 2 ** 31:
        raise ValueError("quickbeam: its counter holds fewer than 2^31 "
                         "(volume, class) pairs")
    build.require_cuda("quickbeam", *ins)
    out = simulate(build.library(), hgt_km, p_hpa, t_c, rh, hm_gkg, re_um,
                   classes, k2, do_ray, use_gas_abs)
    build.LAUNCHES["quickbeam"] += 1
    return out
