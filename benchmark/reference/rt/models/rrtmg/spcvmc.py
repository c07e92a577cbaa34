"""RRTMG-SW two-stream spectral solver (spcvmc / reftra / vrtqdr), plain
PyTorch.

Port of geosradiation_gridcomp_tpu/models/rrtmg/spcvmc.py: PIFM two-stream
layer reflectance and transmittance (reftra_sw, with the conservative
branch decided from an exactly supplied 1 - w and the factored,
resonance-safe non-conservative branch), the vertical adding of vrtqdr_sw
as loops over layers, run once with clear-sky optics and once with the
McICA cloud optics added, then the aggregation over g-points into
broadband, UV and NIR level fluxes and surface band fluxes.

All arrays TOA-first: layer k spans levels k (top) and k+1 (bottom).
"""

import numpy as np
import torch

from .tables_sw import NG_SW

NGB14 = np.repeat(np.arange(1, 15), NG_SW)    # g-point -> band (1..14)
_WCRIT_RESID = 1.0 - 0.9999995

# g-point weights of the aggregates (spcvmc.F90:520-556): UV/vis bands
# 10-13 and NIR bands 1-9 and 14 for the level profiles; at the surface
# NIR bands 1-8 and 14, PAR 10-11 and UV 12-13, band 9 half NIR, half PAR
UV_MASK = ((NGB14 >= 10) & (NGB14 <= 13)).astype(np.float32)
NIR_MASK = ((NGB14 <= 9) | (NGB14 == 14)).astype(np.float32)
NIR_SEL = (((NGB14 <= 8) | (NGB14 == 14)).astype(np.float32)
           + 0.5 * (NGB14 == 9)).astype(np.float32)
PAR_SEL = (((NGB14 >= 10) & (NGB14 <= 11)).astype(np.float32)
           + 0.5 * (NGB14 == 9)).astype(np.float32)
UVR_SEL = ((NGB14 >= 12) & (NGB14 <= 13)).astype(np.float32)

LEVEL_KEYS = ("bbfu", "bbfd", "bbcu", "bbcd", "bbfddir", "bbcddir",
              "uvfd", "uvcd", "uvfddir", "uvcddir", "nifd", "nicd",
              "nifddir", "nicddir")
SFC_KEYS = ("nirr", "nirf", "parr", "parf", "uvrr", "uvrf")
BAND_KEYS = ("fndsbnd", "drband", "dfband")


def reftra_sw(tau, w, g, mu0, womz=None):
    """PIFM two-stream R/T of homogeneous layers (reftra_sw, kmodts=2).

    tau/w/g: [..., nlay, ngpt]; mu0: [...]. womz: 1 - w computed by the
    caller at full relative precision from optical depths (see the
    reference's docstring: the conservative-scattering predicate compares
    a quantity within 5e-7 of 1). Returns (ref, tra, refd, trad).
    """
    if womz is None:
        womz = 1.0 - w
    mu0 = mu0[..., None, None]
    zg3 = 3.0 * g
    gamma1 = (8.0 - w * (5.0 + zg3)) * 0.25
    gamma2 = 3.0 * (w * (1.0 - g)) * 0.25
    gamma3 = (2.0 - zg3 * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    qr = g / (1.0 - g)
    q = qr * qr
    den = 1.0 - womz * q
    tiny = torch.where(den < 0, -1e-12, 1e-12).to(den.dtype)
    den = torch.where(torch.abs(den) < 1e-12, tiny, den)
    conservative = womz * (1.0 - q) / den <= _WCRIT_RESID

    # conservative branch
    za = gamma1 * mu0
    za1c = za - gamma3
    zgt = gamma1 * tau
    ze1c = torch.clamp(tau / mu0, max=500.0)
    ze2c = torch.exp(-ze1c)
    ref_c = (zgt - za1c * (1.0 - ze2c)) / (1.0 + zgt)
    tra_c = 1.0 - ref_c
    refd_c = zgt / (1.0 + zgt)
    trad_c = 1.0 - refd_c
    thin = ze2c == 1.0
    zero = torch.zeros((), dtype=tau.dtype, device=tau.device)
    one = torch.ones((), dtype=tau.dtype, device=tau.device)
    ref_c = torch.where(thin, zero, ref_c)
    tra_c = torch.where(thin, one, tra_c)
    refd_c = torch.where(thin, zero, refd_c)
    trad_c = torch.where(thin, one, trad_c)

    # non-conservative branch, the removable resonance at zrk*mu0 = 1
    # factored out analytically (the reference's derivation)
    za1 = gamma1 * gamma4 + gamma2 * gamma3
    za2 = gamma1 * gamma3 + gamma2 * gamma4
    zrk = torch.sqrt(torch.clamp(gamma1 * gamma1 - gamma2 * gamma2,
                                 min=1e-12))
    zrp = zrk * mu0
    opp = 1.0 + zrp
    s = 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrkg = zrk + gamma1
    g3k = zrk * gamma3
    g4k = zrk * gamma4
    zbeta = (gamma1 - zrk) / zrkg

    ze1 = torch.clamp(zrk * tau, max=5.0)
    ze2 = torch.clamp(tau / mu0, max=5.0)
    zem1 = torch.exp(-ze1)
    zep1 = torch.exp(ze1)
    zem2 = torch.exp(-ze2)
    zep2 = torch.exp(ze2)

    u = ze2 - ze1
    s_ok = torch.abs(s) >= 1e-6
    r = torch.where(s_ok, u / torch.where(s_ok, s, one),
                    torch.where(u == 0.0, zero, ze2))
    # psi(+-u) = +-expm1(+-u)/u via exp - 1, quadratic Taylor below 0.01
    small_u = torch.abs(u) <= 0.01
    u_safe = torch.where(small_u, one, u)
    psi_p = torch.where(small_u, 1.0 + u * (0.5 + u * (1.0 / 6.0)),
                        (torch.exp(u) - 1.0) / u_safe)
    psi_m = torch.where(small_u, 1.0 - u * (0.5 - u * (1.0 / 6.0)),
                        -(torch.exp(-u) - 1.0) / u_safe)
    zden = opp * (zrkg * zep1 + (zrk - gamma1) * zem1)
    ref_n = w * ((za2 + g3k) * (zep1 - zem2)
                 + (g3k - za2) * opp * zem2 * r * psi_p) / zden
    tra_n = zem2 * (1.0 - w * ((za1 - g4k) * (zep2 - zem1)
                               - (za1 + g4k) * opp * zep2 * r * psi_m)
                    / zden)
    zemm = zem1 * zem1
    zdend = 1.0 / ((1.0 - zbeta * zemm) * zrkg)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    return (torch.where(conservative, ref_c, ref_n),
            torch.where(conservative, tra_c, tra_n),
            torch.where(conservative, refd_c, refd_n),
            torch.where(conservative, trad_c, trad_n))


def vrtqdr_sw(ref, tra, refd, trad, ref_sfc_dir, ref_sfc_dif, dbt, tdbt):
    """Vertical adding (vrtqdr_sw): a surface->TOA sweep for the composite
    below each level, a TOA->surface sweep for the composite above it.

    ref/tra/refd/trad/dbt: [..., nlay, ngpt]; ref_sfc_dir/dif [..., ngpt];
    tdbt [..., nlay+1, ngpt]. Returns (fd, fu): [..., nlay+1, ngpt].
    """
    nlay = ref.shape[-2]
    prup = [None] * nlay + [ref_sfc_dir]
    prupd = [None] * nlay + [ref_sfc_dif]
    rup, rupd = ref_sfc_dir, ref_sfc_dif
    for k in range(nlay - 1, -1, -1):
        rf, tr, rfd, trd, db = (x[..., k, :] for x in
                                (ref, tra, refd, trad, dbt))
        zrefl = 1.0 / (1.0 - rupd * rfd)
        rup, rupd = (rf + trd * ((tr - db) * rupd + db * rup) * zrefl,
                     rfd + trd * trd * rupd * zrefl)
        prup[k], prupd[k] = rup, rupd

    ztdn = [torch.ones_like(ref_sfc_dir)]
    prdnd = [torch.zeros_like(ref_sfc_dir)]
    for k in range(nlay):
        rf, tr, rfd, trd, db, tdb = (x[..., k, :] for x in
                                     (ref, tra, refd, trad, dbt, tdbt))
        zrefl = 1.0 / (1.0 - rfd * prdnd[k])
        ztdn.append(tdb * tr + trd * ((ztdn[k] - tdb)
                                      + tdb * rf * prdnd[k]) * zrefl)
        prdnd.append(rfd + trd * trd * prdnd[k] * zrefl)
    prup, prupd, ztdn, prdnd = (torch.stack(x, dim=-2)
                                for x in (prup, prupd, ztdn, prdnd))
    zrefl = 1.0 / (1.0 - prdnd * prupd)
    fu = (tdbt * prup + (ztdn - tdbt) * prupd) * zrefl
    fd = tdbt + (ztdn - tdbt + tdbt * prup * prdnd) * zrefl
    return fd, fu


def _solve(tau, w, g, womz, mu0, rdir, rdif):
    ref, tra, refd, trad = reftra_sw(tau, w, g, mu0, womz)
    dbt = torch.exp(-torch.clamp(tau / mu0[..., None, None], max=500.0))
    tdbt = torch.cat([torch.ones_like(dbt[..., :1, :]),
                      torch.cumprod(dbt, dim=-2)], dim=-2)
    fd, fu = vrtqdr_sw(ref, tra, refd, trad, rdir, rdif, dbt, tdbt)
    return fd, fu, tdbt


def clear_optics(taug, taur, taua=None, ssaa=None, asya=None):
    """Clear-sky delta-scaled optics and the exact 1 - w
    (spcvmc.F90:340-356): (tau, w, g, womz), each [ncol, nlay, 112]."""
    if taua is None:
        taua_g = ssaa_g = asya_g = torch.zeros_like(taug)
    else:
        ngb = torch.as_tensor(NGB14 - 1, device=taug.device)
        taua_g, ssaa_g, asya_g = (x[..., ngb] for x in (taua, ssaa, asya))
    ztauo = taur + taug + taua_g
    zomco = taur + taua_g * ssaa_g
    zgco = (asya_g * ssaa_g * taua_g) / torch.clamp(zomco, min=1e-30)
    zomco = zomco / ztauo
    zf = zgco * zgco
    zwf = zomco * zf
    return ((1.0 - zwf) * ztauo, (zomco - zwf) / (1.0 - zwf),
            (zgco - zf) / (1.0 - zf),
            (taug + taua_g * (1.0 - ssaa_g)) / ztauo / (1.0 - zwf))


def allsky_optics(clear, cldymc, taucmc, ssacmc, asmcmc):
    """Clear optics with the (delta-scaled) McICA cloud optics added where
    cloudy: (tau, w, g, womz)."""
    tauo, omco, gco, womz = clear
    tg = tauo * omco * gco + taucmc * ssacmc * asmcmc
    to_ = tauo * omco + taucmc * ssacmc
    tt = tauo + taucmc
    g_all = tg / torch.clamp(to_, min=1e-30)
    w_all = to_ / tt
    womz_all = (tauo * womz + taucmc * (1.0 - ssacmc)) / tt
    return (torch.where(cldymc, tt, tauo), torch.where(cldymc, w_all, omco),
            torch.where(cldymc, g_all, gco),
            torch.where(cldymc, womz_all, womz))


def aggregate(fd_c, fu_c, tdbt_c, fd_a, fu_a, tdbt_a, zincflx):
    """Level fluxes and surface band quantities from the normalized
    per-g fluxes [ncol, nlev, 112] and the incident flux [ncol, 112]."""
    t = lambda a: torch.as_tensor(a, dtype=zincflx.dtype,
                                  device=zincflx.device)
    uv, nir = zincflx * t(UV_MASK), zincflx * t(NIR_MASK)

    def agg(x, wgt):
        return torch.einsum("clg,cg->cl", x, wgt)

    out = dict(
        bbcu=agg(fu_c, zincflx), bbcd=agg(fd_c, zincflx),
        bbcddir=agg(tdbt_c, zincflx),
        bbfu=agg(fu_a, zincflx), bbfd=agg(fd_a, zincflx),
        bbfddir=agg(tdbt_a, zincflx),
        uvcd=agg(fd_c, uv), uvcddir=agg(tdbt_c, uv),
        uvfd=agg(fd_a, uv), uvfddir=agg(tdbt_a, uv),
        nicd=agg(fd_c, nir), nicddir=agg(tdbt_c, nir),
        nifd=agg(fd_a, nir), nifddir=agg(tdbt_a, nir))
    sfc_dir = tdbt_a[..., -1, :] * zincflx
    sfc_tot = fd_a[..., -1, :] * zincflx
    sfc_up = fu_a[..., -1, :] * zincflx
    for kdir, ktot, sel in (("nirr", "nirf", NIR_SEL),
                            ("parr", "parf", PAR_SEL),
                            ("uvrr", "uvrf", UVR_SEL)):
        out[kdir] = sfc_dir @ t(sel)
        out[ktot] = sfc_tot @ t(sel)
    onehot = t(np.eye(14, dtype=np.float32)[NGB14 - 1])
    out["fndsbnd"] = (sfc_tot - sfc_up) @ onehot
    out["drband"] = sfc_dir @ onehot
    out["dfband"] = (sfc_tot - sfc_dir) @ onehot
    return out


def spcvmc_sw(coefs, taug, taur, sfluxzen, mu0, albdir, albdif,
              cldymc, taucmc, ssacmc, asmcmc,
              taua=None, ssaa=None, asya=None, adjflux=1.0, ncld=None):
    """SW flux solver over 112 g-points, clear + McICA-cloudy passes (the
    plain twin of kernel K6).

    coefs: SWCoefs (unused; the reference's signature); taug/taur
    [ncol, nlay, 112]; sfluxzen [ncol, 112]; mu0 [ncol]; albdir/albdif
    [ncol, 14]; cloud arrays [ncol, nlay, 112] (cldymc bool);
    taua/ssaa/asya: optional aerosol optics [ncol, nlay, 14]; adjflux:
    Earth-Sun distance factor. ncld: optional bound on the number of
    LEADING columns that can be cloudy: the all-sky solve runs on those
    only and the rest alias the clear-sky solve (what the all-sky pass
    gives on a clear column).

    Returns dict: the LEVEL_KEYS fluxes [ncol, nlay+1], the SFC_KEYS
    [ncol] and the BAND_KEYS [ncol, 14] surface quantities (W/m^2).
    """
    ncol = taug.shape[0]
    if ncld is not None and ncld >= ncol:
        ncld = None
    mu0c = torch.clamp(mu0, min=1e-4)
    ngb = torch.as_tensor(NGB14 - 1, device=taug.device)
    rdir, rdif = albdir[..., ngb], albdif[..., ngb]

    clear = clear_optics(taug, taur, taua, ssaa, asya)
    fd_c, fu_c, tdbt_c = _solve(*clear, mu0c, rdir, rdif)
    cs = slice(None) if ncld is None else slice(0, ncld)
    fd_a, fu_a, tdbt_a = _solve(
        *allsky_optics(tuple(x[cs] for x in clear), cldymc[cs], taucmc[cs],
                       ssacmc[cs], asmcmc[cs]),
        mu0c[cs], rdir[cs], rdif[cs])
    if ncld is not None:
        fd_a, fu_a, tdbt_a = (torch.cat([a, c[ncld:]]) for a, c in
                              ((fd_a, fd_c), (fu_a, fu_c),
                               (tdbt_a, tdbt_c)))
    zincflx = adjflux * sfluxzen * mu0c[:, None]
    return aggregate(fd_c, fu_c, tdbt_c, fd_a, fu_a, tdbt_a, zincflx)
