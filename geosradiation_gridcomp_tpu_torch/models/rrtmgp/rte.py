"""Generic radiative-transfer equation solvers over optical properties.

Port of geosradiation_gridcomp_tpu/models/rrtmgp/rte.py: rte_sw (two-stream
+ adding, ty_optical_props_2str) and rte_lw (no-scattering transport)
over GENERIC per-g-point optical properties. rte_sw is plain PyTorch on
the PIFM layer R/T and vertical adding of models/rrtmg/spcvmc.py; its
optics are not spcvmc_sw's (w clipped to 1 - 1e-6, delta scaling with
f = g^2, no UV/PAR outputs), so kernel K6 does not compute it: K10
(rte_sw_cuda.py) computes the all-sky and the clear-sky call in one
launch, and rte_sw is its plain twin. rte_lw is
the variable-diffusivity LW transport of models/rrtmg/rtrnmc.py: kernel
K4 for CUDA tensors, the plain twin otherwise (kernels.twins).
"""

import torch

from ...tables import on_device
from ..rrtmg.rtrnmc_cuda import rtrnmc_fast
from ..rrtmg.spcvmc import reftra_sw, vrtqdr_sw
from .sampling import gpoint_bands


def _gsum(x, w):
    """sum_g x[c, l, g] w[c, g] -> [c, l], without a matmul (no TF32)."""
    return (x * w[:, None, :]).sum(dim=-1)


def rte_sw(taug, taur, tau_cld, ssa_cld, g_cld, toa_src, mu0,
           sfc_alb_dir, sfc_alb_dif, band_lims_gpt,
           tau_aer=None, ssa_aer=None, g_aer=None, delta_scale=True):
    """Broadband SW fluxes from per-g-point optical properties.

    Args (TOA-first):
      taug/taur: [ncol, nlay, ngpt] gas and Rayleigh optical depths.
      tau_cld/ssa_cld/g_cld: [ncol, nlay, ngpt] cloud optics (zeros in
        clear cells - McICA-sampled via sampling.draw_samples).
      toa_src: [ncol, ngpt] direct-beam source at TOA (W/m^2 per gpt,
        normal to the beam); mu0: [ncol].
      sfc_alb_dir/dif: [ncol, nbnd] per-band surface albedos.
      band_lims_gpt: [nbnd, 2] static 1-based g-point limits.
      tau_aer/ssa_aer/g_aer: optional [ncol, nlay, nbnd] aerosol optics
        (ssa 1 and g 0 where missing).

    Returns dict: flux_up, flux_dn, flux_dir [ncol, nlev+1] (W/m^2).
    """
    idx = on_device(gpoint_bands(band_lims_gpt), taug.device)

    if delta_scale:
        f = g_cld * g_cld
        tau_c = (1.0 - ssa_cld * f) * tau_cld
        zero = tau_cld.new_zeros(())
        has = tau_cld > 0.0
        ssa_c = torch.where(has, (1.0 - f) * ssa_cld
                            / torch.clamp(1.0 - ssa_cld * f, min=1e-12),
                            zero)
        g_c = torch.where(has, (g_cld - f) / torch.clamp(1.0 - f, min=1e-12),
                          zero)
    else:
        tau_c, ssa_c, g_c = tau_cld, ssa_cld, g_cld

    tau = taug + taur + tau_c
    scat = taur + ssa_c * tau_c
    asym = g_c * ssa_c * tau_c
    if tau_aer is not None:
        ta = tau_aer[..., idx]
        sa = 1.0 if ssa_aer is None else ssa_aer[..., idx]
        ga = 0.0 if g_aer is None else g_aer[..., idx]
        tau = tau + ta
        scat = scat + sa * ta
        asym = asym + ga * sa * ta
    w = torch.clamp(scat / torch.clamp(tau, min=1e-12), 0.0, 1.0 - 1e-6)
    g_eff = asym / torch.clamp(scat, min=1e-12)

    mu0c = torch.clamp(mu0, min=1e-6)
    ref, tra, refd, trad = reftra_sw(tau, w, g_eff, mu0c)
    # direct-beam transmittance: per layer and cumulative at levels
    dbt_lay = torch.exp(-torch.clamp(tau / mu0c[:, None, None], max=500.0))
    tdbt = torch.cat([torch.ones_like(dbt_lay[:, :1]),
                      torch.cumprod(dbt_lay, dim=1)], dim=1)
    fd, fu = vrtqdr_sw(ref, tra, refd, trad, sfc_alb_dir[..., idx],
                       sfc_alb_dif[..., idx], dbt_lay, tdbt)
    inc = toa_src * mu0c[:, None]         # vertical flux per gpt
    return dict(flux_up=_gsum(fu, inc), flux_dn=_gsum(fd, inc),
                flux_dir=_gsum(tdbt, inc))


def rte_lw(taug, sources, sfc_emis, tau_cld=None, cld_mask=None,
           dudts=False):
    """Broadband LW fluxes from per-g-point optical depths and Planck
    sources (no-scattering transport with the variable diffusivity angle
    of rtrnmc; kernel K4, or its twin: kernels.twins).

    taug: [ncol, nlay, ngpt]; sources: dict from KDistLW.gas_optics;
    sfc_emis: [ncol, nbnd]; tau_cld: optional McICA per-g-point cloud
    absorption optical depth; cld_mask: [ncol, nlay] any-gpt-cloudy.

    Returns dict: flux_up, flux_dn, flux_up_clr, flux_dn_clr, olrb
    (+ duflx_dts, duflxc_dts, dolrb_dts when dudts).
    """
    if tau_cld is None:
        tau_cld = torch.zeros_like(taug)
        cloudy = torch.zeros(taug.shape[:2], dtype=torch.bool,
                             device=taug.device)
    else:
        cloudy = cld_mask if cld_mask is not None \
            else (tau_cld > 0.0).any(dim=-1)
    out = rtrnmc_fast(
        sfc_emis.contiguous(), taug, sources["pfracs"], cloudy, tau_cld,
        sources["planklay"], sources["planklev"], sources["plankbnd"],
        sources["dplankbnd_dts"], sources["pwvcm"], dudts=dudts)
    res = dict(flux_up=out["uflx"], flux_dn=out["dflx"],
               flux_up_clr=out["uflxc"], flux_dn_clr=out["dflxc"],
               olrb=out["olrb"])
    if dudts:
        res.update(duflx_dts=out["duflx_dts"],
                   duflxc_dts=out["duflxc_dts"], dolrb_dts=out["dolrb_dts"])
    return res
