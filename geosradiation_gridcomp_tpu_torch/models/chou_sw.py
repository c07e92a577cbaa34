"""Chou-Suarez shortwave flux solver (the reference's `sorad`), PyTorch.

Port of geosradiation_gridcomp_tpu/models/chou_sw.py (sorad.F90:43-1588):
8 bands (5 UV/PAR + 3 NIR x 10 water-vapor k-points), delta-Eddington
two-stream layer optics, the adding method over the 8 maximally/randomly
overlapped sky conditions (high/mid/low cloud groups), and the O2/CO2
broadband flux reductions.

The reference maps one column under vmap; here every array carries the
column batch first:
* the 35 spectral points (5 UV + 30 NIR k-points) are one axis, their
  constants gathered from static arrays;
* all delta-Eddington calls are one batched `deledd` evaluation;
* the adding sweeps (sorad.F90:1244-1315 CLDFLX) are Python loops over
  the static layer ranges of the high/mid/low regions, carrying the
  [ncol, 35, 2, 2, 2] sky-condition tensors.

Outputs are normalized: fractions of the TOA insolation (multiply by
cosz * solar_constant for W/m^2), as in the reference.

The reference jits chou_sw (:333): here its body is `chou_sw_eager` and
`chou_sw` that body as a captured entry (driver/compiled.py), one CUDA
graph per static key on a card; its tables go to the device once per
device and dtype (tables.on_device).
"""

import numpy as np
import torch

from ..ops.chou_optics import getnirtau, getvistau, superlayer_cc
from ..ops.twostream import deledd
from ..driver.compiled import captured
from ..tables import load, on_device

_DSM = 0.602                       # cos(53 deg): diffuse-as-beam angle
_NS = 35                           # 5 UV + 3*10 NIR spectral points


def _spectral_constants():
    """Static per-spectral-point constant arrays (numpy)."""
    t = load("chou_sorad_constants")
    wk = np.concatenate([t["wk_uv"], np.tile(t["xk_ir"], 3)])
    zk = np.concatenate([t["zk_uv"], np.zeros(30, np.float32)])
    ry = np.concatenate([t["ry_uv"], np.repeat(t["ry_ir"], 10)])
    band = np.concatenate([np.arange(5), np.repeat(np.arange(5, 8), 10)])
    optidx = np.concatenate([np.zeros(5, np.int64),
                             np.repeat(np.arange(1, 4), 10)])
    eps_ssa = np.concatenate([np.zeros(5, np.float32),
                              np.full(30, 1e-8, np.float32)])
    return wk, zk, ry, band.astype(np.int64), optidx, eps_ssa


def default_hk():
    """Default band k-weights (no solar-cycle file): hk_uv_old / hk_ir_old
    (GEOS_SolarGridComp.F90:3027-3028)."""
    t = load("chou_sorad_constants")
    return t["hk_uv_old"], t["hk_ir_old"]


def _expand(x, axis):
    """[ncol, ns, 2] layer property -> [ncol, ns, 2, 2, 2] along combo
    axis 1/2/3."""
    if axis == 1:
        return x[:, :, :, None, None]
    if axis == 2:
        return x[:, :, None, :, None]
    return x[:, :, None, None, :]


def _rflx_lookup(tab, u, w, u1, du, w1, dw):
    """Bilinear O2/CO2 flux-reduction table lookup (sorad.F90:1425-1543)."""
    nu_, nw_ = tab.shape
    x0 = u1 + nu_ * du
    y0 = w1 + nw_ * dw
    ulog = torch.clamp(u, max=x0)
    wlog = torch.clamp(w, max=y0)
    ic = torch.clamp(torch.floor((ulog - (u1 - 0.5 * du)) / du + 1.0)
                     .to(torch.int64), 2, nu_)
    iw = torch.clamp(torch.floor((wlog - (w1 - 0.5 * dw)) / dw + 1.0)
                     .to(torch.int64), 2, nw_)
    dc = ulog - (ic - 2).to(u.dtype) * du - u1
    dd = wlog - (iw - 2).to(u.dtype) * dw - w1
    t00 = tab[ic - 2, iw - 2]
    t01 = tab[ic - 2, iw - 1]
    t10 = tab[ic - 1, iw - 2]
    x2 = t00 + (t01 - t00) / dw * dd
    y2 = x2 + (t10 - t00) / du * dc
    return torch.clamp(y2, min=0.0)


def _cumsum0(x):
    """[0, cumsum(x)] along the last axis."""
    return torch.cat([torch.zeros_like(x[..., :1]),
                      torch.cumsum(x, dim=-1)], dim=-1)


def chou_sw_eager(cosz, ple, ta, wa, oa, co2, cwc, fcld, reff,
                  taua=None, ssaa=None, asya=None,
                  rsuvbm=None, rsuvdf=None, rsirbm=None, rsirdf=None,
                  hk_uv=None, hk_ir=None, *, ict, icb):
    """Batched Chou-Suarez SW fluxes (normalized by TOA insolation), run
    op by op.

    Args:
      cosz: [ncol] cosine solar zenith angle
      ple:  [ncol, np+1] level pressure (Pa)
      ta/wa/oa: [ncol, np] temperature / specific humidity / ozone mmr
      co2:  [ncol, np] volume mixing ratio (only co2[:, 0] is used; the
            scheme treats CO2 as well-mixed)
      cwc/reff: [ncol, np, 4]; fcld: [ncol, np]
      taua/ssaa/asya: [ncol, np, 8] aerosol optics per band
      rsuvbm/rsuvdf/rsirbm/rsirdf: [ncol] surface albedos
      hk_uv [5], hk_ir [3, 10]: band spectral weights (default: hk_*_old,
            on the device once per device and dtype)
      ict/icb: super-layer boundary level indices (1-based)

    Returns dict with flx/flc (net down), flxu/flcu (diffuse up), surface
    direct/diffuse components, and per-band surface fluxes. All normalized:
    multiply by cosz * solar-constant for W/m^2.
    """
    ncol, np_ = ta.shape
    dtype, dev = ta.dtype, ta.device

    def const(x):
        return on_device(x, dev, dtype)

    if taua is None:
        taua = torch.zeros((ncol, np_, 8), dtype=dtype, device=dev)
        ssaa = torch.zeros_like(taua)
        asya = torch.zeros_like(taua)
    zeros = torch.zeros((ncol,), dtype=dtype, device=dev)
    rsuvbm = zeros if rsuvbm is None else rsuvbm
    rsuvdf = zeros if rsuvdf is None else rsuvdf
    rsirbm = zeros if rsirbm is None else rsirbm
    rsirdf = zeros if rsirdf is None else rsirdf
    if hk_uv is None:
        hk_uv, hk_ir = (const(x) for x in default_hk())
    hk_s = torch.cat([torch.as_tensor(hk_uv, dtype=dtype, device=dev)
                      .expand(ncol, 5),
                      torch.as_tensor(hk_ir, dtype=dtype, device=dev)
                      .expand(ncol, 3, 10).reshape(ncol, 30)], dim=1)
    # NIR ordering: hk_ir[ib, ik] flattened matches the spectral order

    cosz = torch.clamp(cosz, min=1e-4)
    snt = 1.0 / cosz

    pl = ple * 0.01                       # hPa
    dp = pl[:, 1:] - pl[:, :-1]
    dp_pa = dp * 100.0
    pa = 0.5 * (pl[:, 1:] + pl[:, :-1])

    # scaled water vapor / ozone amounts (sorad.F90:292-319)
    xtoa = torch.clamp(pl[:, 0], min=1e-3)
    scal0 = xtoa * (0.5 * xtoa / 300.0) ** 0.8
    o3toa = 1.02 * oa[:, 0] * xtoa * 466.7 + 1.0e-8
    wvtoa = 1.02 * wa[:, 0] * scal0 * (1.0 + 0.00135 * (ta[:, 0] - 240.0)) \
        + 1.0e-9
    scal = dp * (pa / 300.0) ** 0.8
    wh = 1.02 * wa * scal * (1.0 + 0.00135 * (ta - 240.0)) + 1.0e-9
    oh = 1.02 * oa * dp * 466.7 + 1.0e-8
    swh = wvtoa[:, None] + _cumsum0(wh)   # levels 1..np+1

    # cloud optics for the 4 optics sets (UV + 3 NIR bands)
    tb_uv, tdf_uv, asy_uv = getvistau(cosz, dp_pa, fcld, reff, cwc, ict, icb)
    tb_nir, tdf_nir, asy_nir, ssa_nir = getnirtau(cosz, dp_pa, fcld, reff,
                                                  cwc, ict, icb)
    tauclb_os = torch.cat([tb_uv.sum(-1)[:, None], tb_nir.sum(-1)], 1)
    tauclf_os = torch.cat([tdf_uv.sum(-1)[:, None], tdf_nir.sum(-1)], 1)
    asycl_os = torch.cat([asy_uv[:, None], asy_nir], 1)
    ssacl_os = torch.cat([torch.ones_like(asy_uv)[:, None], ssa_nir], 1)

    wk_s, zk_s, ry_s, band_s, optidx_s, eps_s = _spectral_constants()
    wk_c = const(wk_s)
    zk_c = const(zk_s)
    ry_c = const(ry_s)[:, None]
    eps_c = const(eps_s)[:, None]
    optidx = on_device(optidx_s, dev)
    band = on_device(band_s, dev)

    tauclb = tauclb_os[:, optidx]         # [ncol, ns, np]
    tauclf = tauclf_os[:, optidx]
    asycl = asycl_os[:, optidx]
    scl = ssacl_os[:, optidx]

    taua_s = taua.transpose(1, 2)[:, band]    # [ncol, ns, np]
    ssaa_s = ssaa.transpose(1, 2)[:, band]
    asya_s = asya.transpose(1, 2)[:, band]

    # clear-sky optical properties (Eqs. 6.2-6.4)
    taurs = ry_c * dp[:, None, :]
    tausto = taurs + zk_c[:, None] * oh[:, None, :] \
        + wk_c[:, None] * wh[:, None, :] + taua_s + 1e-7
    ssatau = ssaa_s + taurs + eps_c
    asysto = asya_s

    mu = cosz[:, None, None]
    ssatob_c = torch.clamp(ssatau / tausto + 1e-8, max=0.999999)
    asytob_c = asysto / ssatau
    rr1, tt1, td1 = deledd(tausto, ssatob_c, asytob_c, mu)
    rs1, ts1, _ = deledd(tausto, ssatob_c, asytob_c, _DSM)

    # cloudy: beam and diffuse cloud optical depths scaled separately
    tautob = tausto + tauclb
    ssatob = torch.clamp((ssatau + scl * tauclb) / tautob + 1e-8,
                         max=0.999999)
    asytob = (asysto + asycl * scl * tauclb) / (ssatob * tautob)
    tautof = tausto + tauclf
    ssatof = torch.clamp((ssatau + scl * tauclf) / tautof + 1e-8,
                         max=0.999999)
    asytof = (asysto + asycl * scl * tauclf) / (ssatof * tautof)
    rr2, tt2, td2 = deledd(tautob, ssatob, asytob, mu)
    rs2, ts2, _ = deledd(tautof, ssatof, asytof, _DSM)

    # layer property tensors [ncol, ns, np+2, 2] (k=0 virtual TOA, np+1
    # surface)
    td0 = torch.exp(-(wvtoa[:, None] * wk_c + o3toa[:, None] * zk_c)
                    * snt[:, None])
    uv = band < 5
    sfc_bm = torch.where(uv, rsuvbm[:, None], rsirbm[:, None])
    sfc_df = torch.where(uv, rsuvdf[:, None], rsirdf[:, None])

    def pack(top, lay1, lay2, sfc):
        a = torch.stack([lay1, lay2], dim=-1)                # [n, ns, np, 2]
        topx = top[:, :, None, None].expand(ncol, _NS, 1, 2)
        sfcx = sfc[:, :, None, None].expand(ncol, _NS, 1, 2)
        return torch.cat([topx, a, sfcx], dim=2)

    zero_s = torch.zeros((ncol, _NS), dtype=dtype, device=dev)
    one_s = torch.ones((ncol, _NS), dtype=dtype, device=dev)
    rr_l = pack(zero_s, rr1, rr2, sfc_bm)
    tt_l = pack(one_s, tt1, tt2, zero_s)
    td_l = pack(td0, td1, td2, zero_s)
    rs_l = pack(zero_s, rs1, rs2, sfc_df)
    ts_l = pack(one_s, ts1, ts2, zero_s)

    def layer(k, axis):
        return tuple(_expand(x[:, :, k], axis)
                     for x in (rr_l, tt_l, td_l, rs_l, ts_l))

    # ---- adding method, downward: composite of the layers above ----
    shape = (ncol, _NS, 2, 2, 2)

    def combos(x):
        return x[:, :, None, None, None].expand(shape)
    tda, tta, rsa = (combos(td_l[:, :, 0, 0]), combos(tt_l[:, :, 0, 0]),
                     combos(rs_l[:, :, 0, 0]))
    tda_lev, tta_lev, rsa_lev = [tda], [tta], [rsa]   # k = 0..np
    regions = ((1, ict, 1), (ict, icb, 2), (icb, np_ + 1, 3))
    for lo, hi, axis in regions:
        for k in range(lo, hi):
            rr_k, tt_k, td_k, rs_k, ts_k = layer(k, axis)
            denm = ts_k / (1.0 - rsa * rs_k)
            tda, tta, rsa = (
                tda * td_k,
                tda * tt_k + (tda * rsa * rr_k + tta - tda) * denm,
                rs_k + ts_k * rsa * denm)
            tda_lev.append(tda)
            tta_lev.append(tta)
            rsa_lev.append(rsa)

    # ---- adding method, upward: composite of the layers below ----
    rra, rxa = combos(rr_l[:, :, -1, 0]), combos(rs_l[:, :, -1, 0])
    rra_up, rxa_up = {np_ + 1: rra}, {np_ + 1: rxa}
    for lo, hi, axis in regions[::-1]:
        for k in range(hi - 1, lo - 1, -1):
            rr_k, tt_k, td_k, rs_k, ts_k = layer(k, axis)
            denm = ts_k / (1.0 - rs_k * rxa)
            rra, rxa = (rr_k + (td_k * rra + (tt_k - td_k) * rxa) * denm,
                        rs_k + ts_k * rxa * denm)
            rra_up[k], rxa_up[k] = rra, rxa
    # levels k=1..np+1 on axis 1; the downward composites at index j are
    # those through layer j, i.e. down to level j+1
    tda_lev, tta_lev, rsa_lev = (torch.stack(x, dim=1)
                                 for x in (tda_lev, tta_lev, rsa_lev))
    rra_lev = torch.stack([rra_up[k] for k in range(1, np_ + 2)], dim=1)
    rxa_lev = torch.stack([rxa_up[k] for k in range(1, np_ + 2)], dim=1)

    # fluxes at levels k=1..np+1 (Eqs. 6.15-6.16)
    denm = 1.0 / (1.0 - rsa_lev * rxa_lev)
    fdndir = tda_lev
    xx4 = tda_lev * rra_lev
    yy = tta_lev - tda_lev
    fdndif = (xx4 * rsa_lev + yy) * denm
    fupdif = (xx4 + yy * rxa_lev) * denm
    flxdn = fdndir + fdndif - fupdif

    # sky-condition weights
    cc1, cc2, cc3 = superlayer_cc(fcld, ict, icb)
    wh_ = torch.stack([1.0 - cc1, cc1], dim=-1)
    wm_ = torch.stack([1.0 - cc2, cc2], dim=-1)
    wl_ = torch.stack([1.0 - cc3, cc3], dim=-1)
    ct = wh_[:, :, None, None] * wm_[:, None, :, None] \
        * wl_[:, None, None, :]

    def combo_sum(x):
        return torch.einsum("nlsijk,nijk->nls", x, ct)

    fall = combo_sum(flxdn)               # [ncol, np+1, ns]
    fupa = combo_sum(fupdif)
    fclr = flxdn[..., 0, 0, 0]
    fupc = fupdif[..., 0, 0, 0]
    fsdir_s = combo_sum(fdndir[:, -1:])[:, 0]   # [ncol, ns]
    fsdif_s = combo_sum(fdndif[:, -1:])[:, 0]

    def hk_dot(x):
        return torch.einsum("nls,ns->nl", x, hk_s)

    flx = hk_dot(fall)                    # [ncol, np+1]
    flc = hk_dot(fclr)
    flxu = hk_dot(fupa)
    flcu = hk_dot(fupc)

    onehot_band = torch.nn.functional.one_hot(band, 8).to(dtype)   # [ns, 8]
    flx_sfc_band = (fall[:, -1] * hk_s) @ onehot_band
    sdir = fsdir_s * hk_s
    sdif = fsdif_s * hk_s
    drband = sdir @ onehot_band
    dfband = sdif @ onehot_band

    fdiruv = sdir[:, :4].sum(-1)
    fdifuv = sdif[:, :4].sum(-1)
    fdirpar = sdir[:, 4]
    fdifpar = sdif[:, 4]
    fdirir = sdir[:, 5:].sum(-1)
    fdifir = sdif[:, 5:].sum(-1)

    # ---- O2 and CO2 flux reductions (sorad.F90:1425-1543) ----
    t = load("chou_sorad_constants")
    cah = const(t["cah"])                 # (43, 37)
    coa = const(t["coa"])                 # (62, 101)

    cnt = 165.22 * snt
    scal_lev = scal0[:, None] + _cumsum0(scal)      # levels 1..np+1
    so2_o2 = scal_lev * cnt[:, None]
    df = 0.0633 * (1.0 - torch.exp(-0.000155 * torch.sqrt(so2_o2)))

    co2v = co2[:, 0]
    so2_co2 = (789.0 * co2v)[:, None] * scal_lev
    sntc = snt[:, None]
    df = df + 1.5 * _rflx_lookup(cah, torch.log10(so2_co2 * sntc),
                                 torch.log10(swh * sntc),
                                 -3.0, 0.15, -4.0, 0.15)
    df = df + 1.5 * _rflx_lookup(coa, (co2v * snt)[:, None].expand_as(swh),
                                 torch.log10(pl), 0.000250, 0.000050, -2.0,
                                 0.05)

    # adjust below cloud top (Eq. 6.18)
    cloudy_lay = fcld > 0.02
    ntop = torch.where(cloudy_lay.any(dim=-1),
                       cloudy_lay.to(torch.int8).argmax(dim=-1), np_)
    flx_ntop = flx.gather(1, ntop[:, None])
    df_ntop = df.gather(1, ntop[:, None])
    lev = torch.arange(np_ + 1, device=dev)
    adj = df_ntop + (flx / torch.where(flx_ntop != 0.0, flx_ntop, 1.0)) \
        * (df - df_ntop)
    df = torch.where(lev[None, :] > ntop[:, None], adj, df)

    df = torch.minimum(df, flx - 1.0e-8)
    flx = flx - df
    flc = flc - df

    xx4 = flx[:, -1] + df[:, -1]
    scale = torch.where(torch.abs(xx4) > 1e-30,
                        torch.clamp(1.0 - df[:, -1] / xx4, 0.0, 1.0), 0.0)
    sc = scale[:, None]
    return dict(
        flx=flx, flc=flc, flxu=flxu, flcu=flcu,
        fdiruv=fdiruv * scale, fdifuv=fdifuv * scale,
        fdirpar=fdirpar * scale, fdifpar=fdifpar * scale,
        fdirir=fdirir * scale, fdifir=fdifir * scale,
        flx_sfc_band=flx_sfc_band * sc,
        drband=drband * sc, dfband=dfband * sc)


chou_sw = captured(chou_sw_eager, static_argnames=("ict", "icb"))
chou_sw.__doc__ = """Batched Chou-Suarez SW fluxes (chou_sw_eager's
arguments and results), as a CUDA graph captured once per static key on
a card (the reference's static argnames, models/chou_sw.py:333; hk_uv /
hk_ir, when given, are traced tensors); CPU tensors run the body
eagerly."""
