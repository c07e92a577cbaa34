"""SW two-stream solver (kernel K6) and its plain twin.

Replaces the TPU kernels geosradiation_gridcomp_tpu/models/rrtmg/
spcvmc_pallas.py:spcvmc_fast (two pallas_calls: up pass, then down pass)
with one CUDA launch (csrc/spcvmc.cu) that computes what the CPU oracle
spcvmc_sw computes: one block per column, one thread per g-point carrying
the clear and the all-sky stream through the up and down adding sweeps;
the up sweep keeps each layer's reflectance and transmittance in a
scratch for the down sweep;
each level's sums over g are taken from shared memory in g order after
the sweep, so they are deterministic. The all-sky stream honours ncld as
the oracle does.
"""

import functools

import numpy as np
import torch

from ...kernels import build
from .spcvmc import (BAND_KEYS, LEVEL_KEYS, NIR_MASK, NIR_SEL, PAR_SEL,
                     SFC_KEYS, UV_MASK, UVR_SEL, spcvmc_sw)

# rows of the kernel's g-point weight table
WEIGHTS = np.stack([UV_MASK, NIR_MASK, NIR_SEL, PAR_SEL, UVR_SEL])


@functools.lru_cache(maxsize=None)
def device_weights(device):
    """WEIGHTS on `device`, copied from the host once per device: a copy
    from host memory in every call would synchronise the stream.
    RRTMGSW fills it when it is built on a card."""
    return torch.as_tensor(WEIGHTS, device=device)


def launch(lib, taug, taur, sfluxzen, mu0, albdir, albdif, cldymc, taucmc,
           ssacmc, asmcmc, taua=None, ssaa=None, asya=None, adjflux=1.0,
           ncld=None):
    """Allocate the outputs and scratch and launch K6 from lib; returns
    the dict of spcvmc_sw's outputs."""
    ncol, nlay, _ = taug.shape
    dev = taug.device
    mu0c = torch.clamp(mu0, min=1e-4).contiguous()
    zincflx = (adjflux * sfluxzen * mu0c[:, None]).contiguous()
    weights = device_weights(dev)
    # per (layer, stream): rup, rupd and the layer's ref, tra, refd, trad
    # and direct transmittance
    scratch = torch.empty((ncol, nlay, 2, 7, 112),
                          dtype=torch.float32, device=dev)
    lev = torch.empty((len(LEVEL_KEYS), ncol, nlay + 1), dtype=torch.float32,
                      device=dev)
    sfc = torch.empty((len(SFC_KEYS), ncol), dtype=torch.float32, device=dev)
    band = torch.empty((len(BAND_KEYS), ncol, 14), dtype=torch.float32,
                       device=dev)
    aero = [None if x is None else x.contiguous() for x in (taua, ssaa, asya)]
    ptr = lambda x: None if x is None else x.data_ptr()
    fn = build.entry(lib, "spcvmc_sw", 18, 3)
    rc = fn(taug.data_ptr(), taur.data_ptr(), taucmc.data_ptr(),
            ssacmc.data_ptr(), asmcmc.data_ptr(), cldymc.data_ptr(),
            *[ptr(x) for x in aero], mu0c.data_ptr(), albdir.data_ptr(),
            albdif.data_ptr(), zincflx.data_ptr(), weights.data_ptr(),
            scratch.data_ptr(), lev.data_ptr(), sfc.data_ptr(),
            band.data_ptr(), ncol, nlay,
            ncol if ncld is None else min(ncld, ncol), build.stream_of(taug))
    build.check(rc, "spcvmc_sw")
    return {**dict(zip(LEVEL_KEYS, lev)), **dict(zip(SFC_KEYS, sfc)),
            **dict(zip(BAND_KEYS, band))}


def spcvmc_fast(coefs, taug, taur, sfluxzen, mu0, albdir, albdif, cldymc,
                taucmc, ssacmc, asmcmc, taua=None, ssaa=None, asya=None,
                adjflux=1.0, ncld=None):
    """K6: same contract as spcvmc.spcvmc_sw.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if taug.device.type == "cpu":
        return spcvmc_sw(coefs, taug, taur, sfluxzen, mu0, albdir, albdif,
                         cldymc, taucmc, ssacmc, asmcmc, taua=taua,
                         ssaa=ssaa, asya=asya, adjflux=adjflux, ncld=ncld)
    ins = (taug, taur, sfluxzen, mu0, albdir, albdif, cldymc, taucmc,
           ssacmc, asmcmc)
    aero = [x for x in (taua, ssaa, asya) if x is not None]
    build.require_cuda("spcvmc_fast", *ins, *aero)
    ncol, nlay, ngpt = taug.shape
    if ngpt != 112 or any(x.shape != taug.shape for x in
                          (taur, cldymc, taucmc, ssacmc, asmcmc)):
        raise ValueError("spcvmc_fast: g-point inputs must be "
                         "[ncol, nlay, 112]")
    if albdir.shape != (ncol, 14) or albdif.shape != (ncol, 14) \
            or sfluxzen.shape != (ncol, 112) or mu0.shape != (ncol,):
        raise ValueError("spcvmc_fast: bad albedo/sfluxzen/mu0 shape")
    if len(aero) not in (0, 3) or any(x.shape != (ncol, nlay, 14)
                                      for x in aero):
        raise ValueError("spcvmc_fast: aerosol optics must be all three "
                         "[ncol, nlay, 14] or none")
    if cldymc.dtype != torch.bool or any(
            x.dtype != torch.float32 for x in ins + tuple(aero)
            if x is not cldymc):
        raise TypeError("spcvmc_fast: float inputs must be float32, "
                        "cldymc bool")
    out = launch(build.library(), taug, taur, sfluxzen, mu0, albdir, albdif,
                 cldymc, taucmc, ssacmc, asmcmc, taua, ssaa, asya, adjflux,
                 ncld)
    build.LAUNCHES["spcvmc"] += 1
    return out
