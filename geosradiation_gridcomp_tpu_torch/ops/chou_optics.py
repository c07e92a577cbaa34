"""Chou-Suarez cloud optical properties (the reference's gettau module).

Port of geosradiation_gridcomp_tpu/ops/chou_optics.py: getirtau,
getvistau and getnirtau (gettau.F90:33-227 and the *.code includes),
polynomial fits in hydrometeor effective radius for optical depth,
single-scattering albedo and asymmetry, for 4 hydrometeor classes (ice,
liquid, rain, snow). The reference's getvistau/getnirtau take one column
under vmap; here they take a column batch: cosz [ncol], fields
[ncol, nlev(, 4)].

Coefficient tables keep the Fortran index order, e.g. aib_ir has shape
(3, 10) = (coef, band); scalars of the tables enter the arithmetic as the
same float32 values the reference uses. The tables that enter as tensors
are put on the device once per device and dtype (tables.on_device).
"""

import torch

from ..constants import DIFFUSIVITY, GRAV
from ..tables import load, on_device


def _poly3(c0, c1, c2, c3, r):
    """c0 + (c1 + (c2 + c3*r)*r)*r  (Chou TM eq. 6.5/6.6 form)."""
    return c0 + (c1 + (c2 + c3 * r) * r) * r


def getirtau(dp_pa, fcld, reff, cwc):
    """IR cloud optical depth, layer transmittance and effective cloud cover.

    Mirrors getirtau.code: tau from Eqs. (6.4a,b)/(6.7) of the Chou TM, LW
    scattering parameterized by the similarity transform (Eqs. 6.11-6.12),
    diffuse transmittance exp(-1.66 tau), enn = fcld*(1-transmittance).

    Args:
      dp_pa: [..., nlev] layer pressure thickness (Pa)
      fcld:  [..., nlev] cloud fraction
      reff:  [..., nlev, 4] effective radii (micron): ice, liquid, rain, snow
      cwc:   [..., nlev, 4] hydrometeor mass mixing ratios (kg/kg)

    Returns:
      tcldlyr: [..., 10, nlev] layer diffuse transmittance per band
      enn:     [..., 10, nlev] effective cloud cover per band
      taudiag: [..., 10, nlev] total cloud optical depth per band
    """
    t = load("chou_rad_constants")

    def tab(k):
        return on_device(t[k], dp_pa.device, dp_pa.dtype)
    aib, awb, aiw = tab("aib_ir"), tab("awb_ir"), tab("aiw_ir")
    aww, aig, awg = tab("aww_ir"), tab("aig_ir"), tab("awg_ir")

    # water path per layer in g/m^2: dp[Pa] * 1e3 / g * q[kg/kg]
    wp = (dp_pa * 1.0e3 / GRAV)[..., None, :, None] * cwc[..., None, :, :]
    # wp shape [..., 1, nlev, 4]; band axis broadcast to 10 below.

    re_ice = reff[..., None, :, 0]
    re_liq = reff[..., None, :, 1]
    re_snow = torch.clamp(reff[..., None, :, 3], max=112.0)

    # per-band coefficients broadcast as [10, 1]
    def band(c, i):
        return c[i][:, None]

    zero = torch.zeros((), dtype=dp_pa.dtype, device=dp_pa.device)
    tau_ice = torch.where(
        re_ice > 0.0,
        wp[..., 0] * (band(aib, 0) + band(aib, 1)
                      / torch.clamp(re_ice, min=1e-6) ** band(aib, 2)),
        zero)
    tau_liq = wp[..., 1] * _poly3(band(awb, 0), band(awb, 1), band(awb, 2),
                                  band(awb, 3), re_liq)
    tau_rain = 0.00307 * wp[..., 2]
    tau_snow = torch.where(
        re_snow > 0.0,
        wp[..., 3] * (band(aib, 0) + band(aib, 1)
                      / torch.clamp(re_snow, min=1e-6) ** band(aib, 2)),
        zero)

    tauc = tau_ice + tau_liq + tau_rain + tau_snow
    taudiag = tauc

    w1 = tau_ice * _poly3(band(aiw, 0), band(aiw, 1), band(aiw, 2),
                          band(aiw, 3), re_ice)
    w2 = tau_liq * _poly3(band(aww, 0), band(aww, 1), band(aww, 2),
                          band(aww, 3), re_liq)
    w3 = tau_rain * 0.54
    w4 = tau_snow * _poly3(band(aiw, 0), band(aiw, 1), band(aiw, 2),
                           band(aiw, 3), re_snow)
    wsum = w1 + w2 + w3 + w4
    ww = wsum / torch.clamp(tauc, min=1e-20)

    g1 = w1 * _poly3(band(aig, 0), band(aig, 1), band(aig, 2),
                     band(aig, 3), re_ice)
    g2 = w2 * _poly3(band(awg, 0), band(awg, 1), band(awg, 2),
                     band(awg, 3), re_liq)
    g3 = w3 * 0.95
    g4 = w4 * _poly3(band(aig, 0), band(aig, 1), band(aig, 2),
                     band(aig, 3), re_snow)
    nonzero = wsum != 0.0
    gg = torch.where(nonzero, (g1 + g2 + g3 + g4)
                     / torch.where(nonzero, wsum, 1.0), 0.5)

    # similarity scaling for LW scattering (Eqs. 6.11, 6.12)
    ff = 0.5 + (0.3739 + (0.0076 + 0.1185 * gg) * gg) * gg
    tau_eff = torch.clamp(1.0 - ww * ff, min=0.0) * tauc

    active = (tauc > 0.02) & (fcld[..., None, :] > 0.01)
    tcldlyr = torch.where(active, torch.exp(-DIFFUSIVITY * tau_eff), 1.0)
    enn = torch.where(active, fcld[..., None, :] * (1.0 - tcldlyr), 0.0)
    return tcldlyr, enn, taudiag


# ---------------------------------------------------------------------------
# Shortwave (getvistau/getnirtau): max-overlap scaling via caib/caif tables
# ---------------------------------------------------------------------------

_NM, _NT, _NA = 11, 9, 11
_DM, _DT, _DA, _T1 = 0.1, 0.30103, 0.1, -0.9031


def _quad3(tab, f):
    """(-tab(-1)*(1-f) + tab(+1)*(1+f))*f*0.5 + tab(0)*(1-f*f) along one
    axis; `tab(d)` gives the table at offset d from the centre."""
    return (-tab(-1) * (1.0 - f) + tab(1) * (1.0 + f)) * f * 0.5 \
        + tab(0) * (1.0 - f * f)


def _overlap_scales(cosz, tauc, fa):
    """Beam & diffuse cloud-optical-depth scaling factors (Eqs. 7.3/7.4).

    Trilinear/quadratic lookup in caib(11,9,11) and caif(9,11)
    (getvistau.code:95-170). cosz [ncol]; tauc, fa [ncol, nlev].
    Returns (xai_beam, xai_diff).
    """
    t = load("chou_rad_constants")
    caib = on_device(t["caib"], tauc.device, tauc.dtype)
    caif = on_device(t["caif"], tauc.device, tauc.dtype)

    tauc = torch.clamp(tauc, max=32.0)
    fm = (cosz / _DM)[:, None]
    ft = (torch.log10(torch.clamp(tauc, min=1e-20)) - _T1) / _DT
    fa = fa / _DA

    def centre(f, n):
        return torch.clamp(torch.floor(f + 1.5).to(torch.int64), 2, n - 1)
    im, it, ia = centre(fm, _NM), centre(ft, _NT), centre(fa, _NA)
    fm = fm - (im - 1).to(tauc.dtype)
    ft = ft - (it - 1).to(tauc.dtype)
    fa = fa - (ia - 1).to(tauc.dtype)
    i0, j0, k0 = im - 1, it - 1, ia - 1   # 0-based centres

    xb = _quad3(lambda d: caib[i0 + d, j0, k0], fm)
    xb = xb + _quad3(lambda d: caib[i0, j0 + d, k0], ft)
    xb = xb + _quad3(lambda d: caib[i0, j0, k0 + d], fa)
    xb = torch.clamp(xb - 2.0 * caib[i0, j0, k0], 0.0, 1.0)

    xd = _quad3(lambda d: caif[j0 + d, k0], ft)
    xd = xd + _quad3(lambda d: caif[j0, k0 + d], fa)
    xd = torch.clamp(xd - caif[j0, k0], 0.0, 1.0)
    return xb, xd


def _max0(x):
    """max(0, max over the last axis), 0 for an empty axis (the
    reference's jnp.max(..., initial=0.0))."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.clamp(x.amax(dim=-1), min=0.0)


def superlayer_cc(fcld, ict, icb):
    """Max cloud fraction of the (high, mid, low) groups; fcld [ncol, nlev]
    -> three [ncol]."""
    return (_max0(fcld[..., :ict - 1]), _max0(fcld[..., ict - 1:icb - 1]),
            _max0(fcld[..., icb - 1:]))


def _overlap_fraction(fcld, ict, icb):
    """fcld over the max cloud fraction of its group (0 where clear)."""
    cc1, cc2, cc3 = superlayer_cc(fcld, ict, icb)
    k = torch.arange(1, fcld.shape[-1] + 1, device=fcld.device)
    cc_k = torch.where(k < ict, cc1[:, None],
                       torch.where(k < icb, cc2[:, None], cc3[:, None]))
    return torch.where(cc_k > 0.0, fcld / torch.clamp(cc_k, min=1e-20), 0.0)


def _sw_hydromet_taus(dp_pa, cwc, reff, b_ice, b_liq, b_rain):
    """Hydrometeor optical depths: tau = WP * coef(reff).

    b_ice: scalar aib; b_liq: (c1, c2) -> c1 + c2/reff; b_rain: scalar.
    Returns 4 arrays like cwc[..., i].
    """
    wp = dp_pa * 1.0e3 / GRAV
    re_ice = reff[..., 0]
    re_liq = reff[..., 1]
    re_snow = torch.clamp(reff[..., 3], max=112.0)
    t1 = torch.where(re_ice > 0.0,
                     wp * cwc[..., 0] * b_ice / torch.clamp(re_ice, min=1e-6),
                     0.0)
    t2 = torch.where(re_liq > 0.0,
                     wp * cwc[..., 1] * (b_liq[0] + b_liq[1]
                                         / torch.clamp(re_liq, min=1e-6)),
                     0.0)
    t3 = wp * cwc[..., 2] * b_rain
    t4 = torch.where(re_snow > 0.0,
                     wp * cwc[..., 3] * b_ice
                     / torch.clamp(re_snow, min=1e-6), 0.0)
    return t1, t2, t3, t4


def getvistau(cosz, dp_pa, fcld, reff, cwc, ict, icb):
    """UV/PAR cloud optics (getvistau.code) for a column batch.

    cosz [ncol]; dp_pa, fcld [ncol, nlev]; reff, cwc [ncol, nlev, 4].
    Returns (taubeam [ncol, nlev, 4], taudiff [ncol, nlev, 4],
    asycl [ncol, nlev]). ict/icb are 1-based layer boundary indices
    (overlap scaling on).
    """
    t = load("chou_rad_constants")
    t1_, t2_, t3_, t4_ = _sw_hydromet_taus(
        dp_pa, cwc, reff, float(t["aib_uv"]), t["awb_uv"].tolist(),
        float(t["arb_uv"][0]))
    tauc = t1_ + t2_ + t3_ + t4_

    fa = _overlap_fraction(fcld, ict, icb)
    active = (tauc > 0.02) & (fcld > 0.01)
    xb, xd = _overlap_scales(cosz, tauc, fa)
    xb = torch.where(active, xb, 0.0)
    xd = torch.where(active, xd, 0.0)
    taubeam = torch.stack([t1_ * xb, t2_ * xb, t3_ * xb, t4_ * xb], dim=-1)
    taudiff = torch.stack([t1_ * xd, t2_ * xd, t3_ * xd, t4_ * xd], dim=-1)

    aig = t["aig_uv"].tolist()
    awg = t["awg_uv"].tolist()
    arg = t["arg_uv"].tolist()
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = torch.clamp(reff[..., 3], max=112.0)
    g1 = (aig[0] + (aig[1] + aig[2] * re_i) * re_i) * t1_
    g2 = (awg[0] + (awg[1] + awg[2] * re_l) * re_l) * t2_
    g3 = arg[0] * t3_
    g4 = (aig[0] + (aig[1] + aig[2] * re_s) * re_s) * t4_
    asycl = torch.where(active, (g1 + g2 + g3 + g4)
                        / torch.clamp(tauc, min=1e-20), 1.0)
    return taubeam, taudiff, asycl


def getnirtau(cosz, dp_pa, fcld, reff, cwc, ict, icb):
    """NIR cloud optics (getnirtau.code) for a column batch, all 3 IR bands
    at once.

    Returns (taubeam [ncol, 3, nlev, 4], taudiff [ncol, 3, nlev, 4],
    asycl [ncol, 3, nlev], ssacl [ncol, 3, nlev]).
    """
    t = load("chou_rad_constants")
    aib = float(t["aib_nir"])
    awb = t["awb_nir"].tolist()    # (3 bands, 2)
    arb = t["arb_nir"].tolist()    # (3, 2)
    aia = t["aia_nir"].tolist()    # (3, 3)
    awa = t["awa_nir"].tolist()
    ara = t["ara_nir"].tolist()
    aig = t["aig_nir"].tolist()
    awg = t["awg_nir"].tolist()
    arg = t["arg_nir"].tolist()

    fa = _overlap_fraction(fcld, ict, icb)
    wp = dp_pa * 1.0e3 / GRAV
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = torch.clamp(reff[..., 3], max=112.0)
    # the asymmetry of snow uses the UNCLAMPED snow radius, matching
    # getnirtau.code:200-206
    re_s_raw = reff[..., 3]

    outs = []
    for ib in range(3):
        t1_ = torch.where(re_i > 0.0,
                          wp * cwc[..., 0] * aib
                          / torch.clamp(re_i, min=1e-6), 0.0)
        t2_ = torch.where(re_l > 0.0,
                          wp * cwc[..., 1]
                          * (awb[ib][0] + awb[ib][1]
                             / torch.clamp(re_l, min=1e-6)), 0.0)
        t3_ = wp * cwc[..., 2] * arb[ib][0]
        t4_ = torch.where(re_s > 0.0,
                          wp * cwc[..., 3] * aib
                          / torch.clamp(re_s, min=1e-6), 0.0)
        tauc = t1_ + t2_ + t3_ + t4_
        active = (tauc > 0.02) & (fcld > 0.01)
        xb, xd = _overlap_scales(cosz, tauc, fa)
        xb = torch.where(active, xb, 0.0)
        xd = torch.where(active, xd, 0.0)
        taubeam = torch.stack([t1_ * xb, t2_ * xb, t3_ * xb, t4_ * xb], -1)
        taudiff = torch.stack([t1_ * xd, t2_ * xd, t3_ * xd, t4_ * xd], -1)

        a, w, r = aia[ib], awa[ib], ara[ib]
        w1 = (1.0 - (a[0] + (a[1] + a[2] * re_i) * re_i)) * t1_
        w2 = (1.0 - (w[0] + (w[1] + w[2] * re_l) * re_l)) * t2_
        w3 = (1.0 - r[0]) * t3_
        w4 = (1.0 - (a[0] + (a[1] + a[2] * re_s) * re_s)) * t4_
        wsum = w1 + w2 + w3 + w4
        ssacl = torch.where(active, wsum / torch.clamp(tauc, min=1e-20),
                            0.99999)
        gi, gw, gr = aig[ib], awg[ib], arg[ib]
        g1 = (gi[0] + (gi[1] + gi[2] * re_i) * re_i) * w1
        g2 = (gw[0] + (gw[1] + gw[2] * re_l) * re_l) * w2
        g3 = gr[0] * w3
        g4 = (gi[0] + (gi[1] + gi[2] * re_s_raw) * re_s_raw) * w4
        nonzero = wsum != 0.0
        asycl = torch.where(active & nonzero,
                            (g1 + g2 + g3 + g4)
                            / torch.where(nonzero, wsum, 1.0), 1.0)
        outs.append((taubeam, taudiff, asycl, ssacl))
    return tuple(torch.stack([o[i] for o in outs], dim=1) for i in range(4))
