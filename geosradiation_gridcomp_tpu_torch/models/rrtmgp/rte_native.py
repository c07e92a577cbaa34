"""Band-agnostic LW and SW RTE for native k-distributions.

Port of geosradiation_gridcomp_tpu/models/rrtmgp/rte_native.py, in plain
PyTorch (the reference leaves it to XLA). A NATIVE k-distribution
(gas_optics.py) can carry any band structure, so rte_lw_native is the
generic no-scattering solve: linear-in-tau Planck sources per g-point, a
fixed diffusivity angle (RRTMGP's 1-angle default, secdiff = 1.66),
surface emission + reflection, down then up loops over layers;
rte_sw_native is the two-stream + adding of models/rrtmg/spcvmc.py with
generic band maps. Sums over g-points are plain sums, over each band's
g-point range for the band outputs (no matmul, so no TF32).

Source units contract: sources["planklay"/"planklev"/"plankbnd"] are
BAND-INTEGRATED Planck fluxes [W/m^2]; g-point sources are
pfracs * planck(band).
"""

import numpy as np
import torch

from ...tables import on_device
from ..rrtmg.spcvmc import reftra_sw, vrtqdr_sw
from .rte import _gsum
from .sampling import gpoint_bands


def _tfn(od):
    tr = torch.exp(-od)
    safe = torch.clamp(od, min=1e-9)
    direct = 1.0 - 2.0 * (1.0 / safe - tr / torch.clamp(1.0 - tr,
                                                        min=1e-12))
    return torch.where(od < 0.06, od / 6.0, direct)


def _band_sums(x, band_lims_gpt):
    """[..., ngpt] -> [..., nbnd]: the sum over each band's g-points."""
    lims = np.asarray(band_lims_gpt)
    return torch.stack([x[..., int(g1) - 1:int(g2)].sum(dim=-1)
                        for g1, g2 in lims], dim=-1)


def rte_lw_native(taug, sources, emis_bnd, band_lims_gpt,
                  tau_cld=None, secdiff=1.66, dudts=False):
    """Generic LW fluxes.

    taug: [ncol, nlay, ngpt]; emis_bnd [ncol, nbnd];
    band_lims_gpt [nbnd, 2] 1-based inclusive; tau_cld optional
    [ncol, nlay, ngpt] (absorption).
    Returns dict uflx/dflx/uflxc/dflxc [ncol, nlay+1] (W/m^2) and
    olrb [ncol, nbnd]; with dudts, also duflx_dts/duflxc_dts
    [ncol, nlay+1] and dolrb_dts [ncol, nbnd], the analytic upward
    Jacobian: d(rad0)/dTs = emis*pfrac_sfc*dplankbnd_dts attenuated by
    prod(1-a) toward TOA (the Ts-only linearization the reference stores
    as DUFLX_DT).
    """
    ncol, nlay, ngpt = taug.shape
    gband = on_device(gpoint_bands(band_lims_gpt), taug.device)

    pf = sources["pfracs"]
    lay_g = pf * sources["planklay"][..., gband]
    lev_g = sources["planklev"][..., gband]      # [ncol, nlay+1, ngpt]
    sfc_g = pf[:, -1, :] * sources["plankbnd"][..., gband]
    emis_g = emis_bnd[..., gband]

    tau_tot = taug if tau_cld is None else taug + tau_cld

    # linear-in-tau Planck: the source toward a boundary blends the
    # boundary-level Planck with the layer mean via the pade-style tfn
    odl = torch.clamp(secdiff * tau_tot, min=0.0)
    a_all = 1.0 - torch.exp(-odl)
    tf_all = _tfn(odl)
    odc = torch.clamp(secdiff * taug, min=0.0)
    a_clr = 1.0 - torch.exp(-odc)
    tf_clr = _tfn(odc)
    blev_below = lev_g[:, 1:, :] * pf
    blev_above = lev_g[:, :-1, :] * pf

    dsfc_g = (emis_g * pf[:, -1, :]
              * sources["dplankbnd_dts"][..., gband]) if dudts else None

    def fluxes(a, tf):
        bbd = blev_below + tf * (lay_g - blev_below)
        bbu = blev_above + tf * (lay_g - blev_above)
        rad = torch.zeros((ncol, ngpt), dtype=a.dtype, device=a.device)
        dn = [rad]
        for k in range(nlay):
            rad = rad + (bbd[:, k] - rad) * a[:, k]
            dn.append(rad)
        rad0 = emis_g * sfc_g + (1.0 - emis_g) * rad
        rad = rad0
        up = [rad0]
        for k in range(nlay - 1, -1, -1):
            rad = rad + (bbu[:, k] - rad) * a[:, k]
            up.append(rad)
        dflx_lev = torch.stack(dn, dim=1)           # [ncol, nlay+1, ngpt]
        uflx_lev = torch.stack(up[::-1], dim=1)
        dflx = dflx_lev.sum(dim=-1)
        uflx = uflx_lev.sum(dim=-1)
        olrb = _band_sums(uflx_lev[:, 0], band_lims_gpt)
        if not dudts:
            return uflx, dflx, olrb, None, None
        # Ts Jacobian: the surface perturbation dsfc_g propagates up
        # attenuated by (1-a) per layer (rad' = rad*(1-a) + src*a)
        trn = torch.cat([torch.flip(torch.cumprod(
            torch.flip(1.0 - a, (1,)), dim=1), (1,)),
            torch.ones_like(a[:, :1, :])], dim=1)   # [ncol, nlay+1, ngpt]
        du_g = dsfc_g[:, None, :] * trn
        return (uflx, dflx, olrb, du_g.sum(dim=-1),
                _band_sums(du_g[:, 0], band_lims_gpt))

    uflx, dflx, olrb, duflx, dolrb = fluxes(a_all, tf_all)
    uflxc, dflxc, _, duflxc, _ = fluxes(a_clr, tf_clr)
    out = dict(uflx=uflx, dflx=dflx, uflxc=uflxc, dflxc=dflxc, olrb=olrb)
    if dudts:
        out.update(duflx_dts=duflx, duflxc_dts=duflxc, dolrb_dts=dolrb)
    return out


def rte_sw_native(taug, taur, toa_src, mu0, alb_dir_bnd, alb_dif_bnd,
                  band_lims_gpt, tau_cld=None, ssa_cld=None,
                  g_cld=None, tau_aer=None, ssa_aer=None, g_aer=None):
    """Band-agnostic SW two-stream + adding for native k-distributions.

    taug/taur [ncol, nlay, ngpt]; toa_src [ncol, ngpt] (W/m^2 per gpt at
    overhead sun); mu0 [ncol]; albedos [ncol, nbnd]; cloud optics
    optional [ncol, nlay, ngpt]; aerosol optics optional
    [ncol, nlay, nbnd] (ssa and g zero where missing). Returns
    flux_dn/flux_up/flux_dir, flux_dn_clr/flux_up_clr [ncol, nlay+1]
    plus band_dn_sfc [ncol, nbnd]. Night columns (mu0 <= 0) return zero
    fluxes, matching rrtmg_sw.
    """
    gband = on_device(gpoint_bands(band_lims_gpt), taug.device)
    mu0c = torch.clamp(mu0, min=1e-4)

    ref_sfc_dir = alb_dir_bnd[..., gband]
    ref_sfc_dif = alb_dif_bnd[..., gband]
    zincflx = toa_src * mu0c[:, None]

    def solve(tau, w, g):
        ref, tra, refd, trad = reftra_sw(tau, w, g, mu0c)
        dbt = torch.exp(-torch.clamp(tau / mu0c[:, None, None], max=500.0))
        tdbt = torch.cat([torch.ones_like(dbt[..., :1, :]),
                          torch.cumprod(dbt, dim=-2)], dim=-2)
        fd, fu = vrtqdr_sw(ref, tra, refd, trad, ref_sfc_dir,
                           ref_sfc_dif, dbt, tdbt)
        return fd, fu, tdbt

    # aerosols (band-resolved, expanded to g-points) enter BOTH sky
    # states: "clear" means cloud-free, aerosol-laden
    base_tau, base_scat, base_asym = taug + taur, taur, 0.0
    if tau_aer is not None:
        ta_g = tau_aer[..., gband]
        sa_g = (ssa_aer if ssa_aer is not None
                else torch.zeros_like(tau_aer))[..., gband]
        ga_g = (g_aer if g_aer is not None
                else torch.zeros_like(tau_aer))[..., gband]
        base_tau = base_tau + ta_g
        base_scat = base_scat + sa_g * ta_g
        base_asym = ga_g * sa_g * ta_g
    w_clr = base_scat / torch.clamp(base_tau, min=1e-30)
    g_clr = base_asym / torch.clamp(base_scat, min=1e-30) \
        if tau_aer is not None else torch.zeros_like(taug)
    fd_c, fu_c, dir_c = solve(base_tau, w_clr, g_clr)

    if tau_cld is None:
        fd_a, fu_a, dir_a = fd_c, fu_c, dir_c
    else:
        tt = base_tau + tau_cld
        scat = base_scat + ssa_cld * tau_cld
        g_all = (base_asym + g_cld * ssa_cld * tau_cld) \
            / torch.clamp(scat, min=1e-30)
        w_all = scat / torch.clamp(tt, min=1e-30)
        fd_a, fu_a, dir_a = solve(tt, w_all, g_all)

    day = (mu0 > 0.0).to(taug.dtype)[:, None]
    out = dict(flux_dn=day * _gsum(fd_a, zincflx),
               flux_up=day * _gsum(fu_a, zincflx),
               flux_dir=day * _gsum(dir_a, zincflx),
               flux_dn_clr=day * _gsum(fd_c, zincflx),
               flux_up_clr=day * _gsum(fu_c, zincflx))
    out["band_dn_sfc"] = day * _band_sums(fd_a[:, -1, :] * zincflx,
                                          band_lims_gpt)
    return out
