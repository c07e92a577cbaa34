"""LW no-scattering transfer (kernel K4) and its plain twin.

Replaces the TPU kernels geosradiation_gridcomp_tpu/models/rrtmg/
rtrnmc_pallas.py:rtrnmc_fast (two pallas_calls: down sweep, then up
sweep) with one CUDA launch (csrc/rtrnmc.cu) that computes what the CPU
oracle rtrnmc computes: one thread per (column, g-point) runs the down
sweep, the surface emission and reflection and the up sweep in registers,
its inputs streamed through a ring of asynchronous copies in shared
memory, and each level's band-weighted flux sums are reduced over g a
batch of levels at a time. The kernel computes the diffusivity secant
from pwvcm and holds the band widths itself, so a call copies nothing
from the host (such a copy would synchronise the stream).
"""

import torch

from ...kernels import build
from .rtrnmc import rtrnmc

OUT_LEVEL = ("uflx", "dflx", "uflxc", "dflxc", "duflx_dts", "duflxc_dts")
OUT_BAND = ("olrb", "dolrb_dts")


def launch(lib, semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
           plankbnd, dplankbnd_dts, pwvcm):
    """Allocate the outputs and launch K4 from lib; returns the dict of
    all eight outputs."""
    ncol, nlay, ngpt = taug.shape
    dev = taug.device
    out = {k: torch.empty((ncol, nlay + 1), dtype=torch.float32, device=dev)
           for k in OUT_LEVEL}
    out.update({k: torch.empty((ncol, 16), dtype=torch.float32, device=dev)
                for k in OUT_BAND})
    fn = build.entry(lib, "rtrnmc_lw", 18, 2)
    rc = fn(semiss.data_ptr(), pwvcm.data_ptr(), taug.data_ptr(),
            pfracs.data_ptr(), taucmc.data_ptr(), cloudy.data_ptr(),
            planklay.data_ptr(), planklev.data_ptr(), plankbnd.data_ptr(),
            dplankbnd_dts.data_ptr(),
            *[out[k].data_ptr() for k in OUT_LEVEL + OUT_BAND],
            ncol, nlay, build.stream_of(taug))
    build.check(rc, "rtrnmc_lw")
    return out


def rtrnmc_fast(semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
                plankbnd, dplankbnd_dts, pwvcm, dudts=True):
    """K4: same contract as rtrnmc.rtrnmc.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if taug.device.type == "cpu":
        return rtrnmc(semiss, taug, pfracs, cloudy, taucmc, planklay,
                      planklev, plankbnd, dplankbnd_dts, pwvcm, dudts=dudts)
    ins = (semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
           plankbnd, dplankbnd_dts, pwvcm)
    build.require_cuda("rtrnmc_fast", *ins)
    ncol, nlay, ngpt = taug.shape
    if ngpt != 140 or pfracs.shape != taug.shape \
            or taucmc.shape != taug.shape:
        raise ValueError("rtrnmc_fast: taug/pfracs/taucmc must be "
                         "[ncol, nlay, 140]")
    if planklev.shape != (ncol, nlay + 1, 16) or semiss.shape != (ncol, 16) \
            or planklay.shape != (ncol, nlay, 16) \
            or plankbnd.shape != (ncol, 16) \
            or dplankbnd_dts.shape != (ncol, 16) or pwvcm.shape != (ncol,) \
            or cloudy.shape != (ncol, nlay):
        raise ValueError("rtrnmc_fast: bad Planck/semiss/pwvcm/cloudy "
                         "shape")
    for t in ins:
        if t is not cloudy and t.dtype != torch.float32:
            raise TypeError("rtrnmc_fast: float inputs must be float32")
    if cloudy.dtype != torch.bool:
        raise TypeError("rtrnmc_fast: cloudy must be bool (the kernel reads "
                        "its bytes)")
    out = launch(build.library(), *ins)
    build.LAUNCHES["rtrnmc"] += 1
    if not dudts:
        for k in ("duflx_dts", "duflxc_dts", "dolrb_dts"):
            del out[k]
    return out
