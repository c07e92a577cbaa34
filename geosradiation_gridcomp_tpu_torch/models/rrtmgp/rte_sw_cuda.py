"""RRTMGP's SW solver for both streams: kernel K10 (csrc/rte_sw.cu) and
its plain twin.

K10 computes on the card, in one launch, what its twin computes in plain
PyTorch: rte.rte_sw with the McICA cloud optics (all sky), then rte.rte_sw
with zero cloud optics (clear sky), each its delta scaling, optics, PIFM
layer R/T, direct beam, adding sweeps and sums over g. A g-point's fluxes
are the twin's bit for bit (the kernel rounds each operation as PyTorch
does); the sums over g run in g order, PyTorch's in its own. The scheme
calls rte_sw_fast; the twin runs unless kernels.twins.use_kernel.
"""

import torch

from ...kernels import build
from ...kernels.twins import use_kernel
from ...tables import on_device
from .rte import rte_sw
from .sampling import gpoint_bands

# the kernel's block: one thread per g-point
MAX_GPT = 128
KEYS = ("flux_up", "flux_dn", "flux_dir")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(lib, taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
           sfc_alb_dir, sfc_alb_dif, band_lims_gpt, tau_aer=None,
           ssa_aer=None, g_aer=None):
    """Allocate the outputs and scratch and launch K10 from lib; returns
    (allsky, clrsky), each a dict of flux_up, flux_dn, flux_dir
    [ncol, nlay+1]."""
    ncol, nlay, ngpt = taug.shape
    dev = taug.device
    band = on_device(gpoint_bands(band_lims_gpt), dev)
    # per (layer, stream): the composite reflectances below the layer's
    # top and its ref, tra, refd, trad and direct transmittance
    scratch = torch.empty((ncol, nlay, 2, 7, ngpt), dtype=torch.float32,
                          device=dev)
    out = torch.empty((6, ncol, nlay + 1), dtype=torch.float32, device=dev)
    fn = build.entry(lib, "rte_sw", 15, 4)
    rc = fn(taug.data_ptr(), taur.data_ptr(), tau_cld.data_ptr(),
            ssa_cld.data_ptr(), g_cld.data_ptr(), _ptr(tau_aer),
            _ptr(ssa_aer), _ptr(g_aer), toa_src.data_ptr(), mu0.data_ptr(),
            sfc_alb_dir.data_ptr(), sfc_alb_dif.data_ptr(), band.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), ncol, nlay, ngpt,
            sfc_alb_dir.shape[1], build.stream_of(taug))
    build.check(rc, "rte_sw")
    return dict(zip(KEYS, out[:3])), dict(zip(KEYS, out[3:]))


def rte_sw_fast(taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
                sfc_alb_dir, sfc_alb_dif, band_lims_gpt, tau_aer=None,
                ssa_aer=None, g_aer=None):
    """The all-sky and the clear-sky rte_sw (rte.rte_sw's arguments, delta
    scaling on) in one call; returns (allsky, clrsky), each rte_sw's dict
    of flux_up, flux_dn, flux_dir [ncol, nlay+1]. K10 (rte_sw_kernel)
    where kernels.twins.use_kernel, the plain twin otherwise."""
    aero = dict(tau_aer=tau_aer, ssa_aer=ssa_aer, g_aer=g_aer)
    if use_kernel(taug):
        return rte_sw_kernel(taug, taur, tau_cld, ssa_cld, g_cld, toa_src,
                             mu0, sfc_alb_dir, sfc_alb_dif, band_lims_gpt,
                             **aero)
    allsky = rte_sw(taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
                    sfc_alb_dir, sfc_alb_dif, band_lims_gpt, **aero)
    zero = torch.zeros_like(tau_cld)
    clrsky = rte_sw(taug, taur, zero, zero, zero, toa_src, mu0, sfc_alb_dir,
                    sfc_alb_dif, band_lims_gpt, **aero)
    return allsky, clrsky


def rte_sw_kernel(taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
                  sfc_alb_dir, sfc_alb_dif, band_lims_gpt, tau_aer=None,
                  ssa_aer=None, g_aer=None):
    """K10 itself: rte_sw_fast's contract on float32 tensors of one CUDA
    device, contiguous: taug, taur and the cloud optics [ncol, nlay, ngpt]
    (ngpt <= 128, the g-points band_lims_gpt covers), toa_src [ncol, ngpt],
    mu0 [ncol], the albedos [ncol, nbnd] and each aerosol field given
    [ncol, nlay, nbnd] (ssa_aer and g_aer only with tau_aer). Raises on
    anything else. Launches once, on the current stream, without a sync.
    """
    aero = [x for x in (tau_aer, ssa_aer, g_aer) if x is not None]
    ins = (taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0, sfc_alb_dir,
           sfc_alb_dif, *aero)
    if any(x.dtype != torch.float32 for x in ins):
        raise TypeError("rte_sw: inputs must be float32")
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("rte_sw: tensors must be contiguous")
    if taug.dim() != 3:
        raise ValueError(f"rte_sw: taug must be [ncol, nlay, ngpt], got "
                         f"{tuple(taug.shape)}")
    ncol, nlay, ngpt = taug.shape
    nbnd = len(band_lims_gpt)
    if ngpt > MAX_GPT or len(gpoint_bands(band_lims_gpt)) != ngpt:
        raise ValueError(f"rte_sw: {ngpt} g-points: at most {MAX_GPT}, as "
                         f"many as band_lims_gpt covers")
    if any(x.shape != taug.shape for x in (taur, tau_cld, ssa_cld, g_cld)):
        raise ValueError("rte_sw: taug, taur and the cloud optics must be "
                         "[ncol, nlay, ngpt]")
    if (toa_src.shape != (ncol, ngpt) or mu0.shape != (ncol,)
            or sfc_alb_dir.shape != (ncol, nbnd)
            or sfc_alb_dif.shape != (ncol, nbnd)):
        raise ValueError("rte_sw: want toa_src [ncol, ngpt], mu0 [ncol] and "
                         "the albedos [ncol, nbnd]")
    if (tau_aer is None and aero) or any(x.shape != (ncol, nlay, nbnd)
                                         for x in aero):
        raise ValueError("rte_sw: aerosol optics must be [ncol, nlay, nbnd],"
                         " ssa_aer and g_aer only with tau_aer")
    build.require_cuda("rte_sw", *ins)
    out = launch(build.library(), taug, taur, tau_cld, ssa_cld, g_cld,
                 toa_src, mu0, sfc_alb_dir, sfc_alb_dif, band_lims_gpt,
                 tau_aer, ssa_aer, g_aer)
    build.LAUNCHES["rte_sw"] += 1
    return out
