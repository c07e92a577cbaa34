"""Chou-Suarez longwave flux solver (the reference's `irrad`), PyTorch.

Port of geosradiation_gridcomp_tpu/models/chou_lw.py (irrad.F90:27-1338:
10-band k-distribution + table-lookup transmission, max-random
3-super-layer cloud overlap, linearized surface-temperature Jacobian
dF/dTs), with the reference's restructuring:

* path transmittances are differences of LEVEL CUMULATIVE SUMS of the
  scaled absorber amounts, so the O(np^2) (k1, k2) pair loop becomes
  broadcast arithmetic on [ncol, nl, nl+1] pair planes;
* the table-lookup bands (h2o bands 1/2/8, co2 band 3, o3 band 5;
  irrad.F90:1887-2013 `tablup`) are gathers from the 26x31/30/21 tables
  on the pair planes;
* max-random overlap (irrad.F90:2513-2603 `cldovlp` + `mkicx`): the
  effective cloudiness of a superlayer for every pair is a recurrence over
  its layers sorted by ascending effective cloudiness (a stable per-column
  sort), run as a Python loop over sorted positions with a per-column
  gather of each position's layer.

The reference maps one column under vmap; here the column batch leads
every array, and `chou_lw` runs it in chunks of columns (the columns are
independent) so that the band's pair planes fit on the card at full width.

Fluxes keep the reference sign convention: downward positive, upward
negative. Outputs are W/m^2 at the np+1 model levels (TOA..surface).

The reference jits chou_lw (:547): here its body is `chou_lw_eager` and
`chou_lw` that body as a captured entry (driver/compiled.py), one CUDA
graph per static key on a card; its tables go to the device once per
device and dtype (tables.on_device).
"""

import torch

from ..constants import DIFFUSIVITY
from ..ops.chou_optics import getirtau
from ..driver.compiled import captured
from ..tables import load, on_device

# CFC temperature-scaling/absorption parameters (irrad.F90:739-770, Table 7)
_CFC_PARAMS = {
    "f11": (1.26610e-3, 3.55940e-6, 1.89736e1, 8.19370e-4, 4.67810e-6, 1.01487e1),
    "f12": (8.77370e-4, -5.88440e-6, 1.58104e1, 8.62000e-4, -4.22500e-6, 3.70107e1),
    "f22": (9.65130e-4, 1.31280e-5, 6.18536e0, -3.00010e-5, 5.25010e-7, 3.27912e1),
}

# k-distribution weights for trace gases (irrad.F90:2185-2356, Tables 5-6)
_N2O_W = {6: (0.940414, 0.059586), 7: (0.561961, 0.138707, 0.240670, 0.058662)}
_N2O_POW = {6: 21.0, 7: 8.0}
_N2O_K = {6: 6.31582e-2, 7: 5.35779e-2}
_CH4_W = {6: (1.0,), 7: (0.610650, 0.280212, 0.107349, 0.001789)}
_CH4_POW = {6: 1.0, 7: 12.0}
_CH4_K = {6: 5.80708e-3, 7: 6.29247e-2}
_COM_W = {4: (0.12159, 0.24359, 0.24981, 0.26427, 0.07807, 0.04267),
          5: (0.06869, 0.14795, 0.19512, 0.33446, 0.17199, 0.08179)}
_COM_K = 1.922e-7   # powers of 5, 6 terms
# band 10 (irrad.F90:1806-1883, 2450-2505)
_B10_H2O_W = (0.3153, 0.4604, 0.1326, 0.0798, 0.0119)
_B10_CO2_W = (0.2673, 0.2201, 0.2106, 0.2409, 0.0196, 0.0415)
_B10_N2O_W = (0.970831, 0.029169)

# columns per chunk: one band keeps some 20 [chunk, nl, nl+1] float32
# planes alive, about 0.9 GB at 2048 columns and 72 layers
CHUNK = 2048


def _planck_all_bands(cb, t):
    """Spectrally-integrated Planck flux for all 10 bands. irrad.F90:
    1341-1356. cb: (6, 10) coefficients; t: [...] temperatures.
    Returns [..., 10]."""
    t = t[..., None]
    out = cb[5]
    for i in (4, 3, 2, 1, 0):
        out = out * t + cb[i]
    return out


def _plancd_all_bands(dcb, t):
    """d(Planck flux)/dT for all 10 bands. irrad.F90:1360-1375."""
    t = t[..., None]
    out = dcb[4]
    for i in (3, 2, 1, 0):
        out = out * t + dcb[i]
    return out


def _pair_delta(x):
    """Pair path sums from per-layer x: out[:, k1, k2] = sum_{k=k1}^{k2-1}
    x[:, k].

    x: [ncol, nl]; returns [ncol, nl, nl+1] (k1 = 0..nl-1, k2 = 0..nl).
    Entries with k2 <= k1 are meaningless (negative sums); callers mask.
    """
    c = torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, dim=1)],
                  dim=1)
    return c[:, None, :] - c[:, :-1, None]


def _kdist_tran(du, kbase, mult, weights):
    """Sum_i w_i * exp(-kbase * mult^(i-1) * du)  (Eqs. 8.23/8.25).

    kbase, mult and the weights keep the reference's scalar types (numpy
    float32 or Python float), so each k is the same value."""
    out = 0.0
    k = kbase
    dup = torch.clamp(du, min=0.0)
    for w in weights:
        out = out + float(w) * torch.exp(-float(k) * dup)
        k = k * mult
    return out


def _tablup(s1, s2, s3, c1, c2, c3, w1, p1, dwe, dpe):
    """Table lookup transmittance factor on the pair planes.
    irrad.F90:1887-2013.

    s1/s2/s3: path sums of (dw, p*dw, dt*dw), any shape.
    c1/c2/c3: (nx, nh) tables. Returns transmittance factor in [1e-7, ~1].
    """
    nx, nh = c1.shape
    tabs = [on_device(c, s1.device, s1.dtype).reshape(-1)
            for c in (c1, c2, c3)]
    s1c = torch.clamp(s1, min=1e-30)
    x2 = s2 / s1c
    x3 = s3 / s1c
    we = torch.clamp((torch.log10(s1c) - float(w1)) * float(dwe),
                     max=float(nh - 1))
    pe = torch.clamp((torch.log10(torch.clamp(x2, min=1e-30)) - float(p1))
                     * float(dpe), max=float(nx - 1))
    iw = torch.clamp(torch.floor(we + 1.0).to(torch.int64), 2, nh - 1)
    fw = we - (iw - 1).to(we.dtype)
    ip = torch.clamp(torch.floor(pe + 1.0).to(torch.int64), 1, nx - 1)
    fp = pe - (ip - 1).to(pe.dtype)

    # 0-based flat gathers; Fortran coef(ip, iw) -> c[ip-1, iw-1]
    base = (ip - 1) * nh + (iw - 1)

    def g(c, di, dj):
        return c[base + (di * nh + dj)]

    c1, c2, c3 = tabs
    pa_ = g(c1, 0, -1) + (g(c1, 1, -1) - g(c1, 0, -1)) * fp
    pb_ = g(c1, 0, 0) + (g(c1, 1, 0) - g(c1, 0, 0)) * fp
    pc_ = g(c1, 0, 1) + (g(c1, 1, 1) - g(c1, 0, 1)) * fp
    ax = ((pc_ + pa_) * fw + (pc_ - pa_)) * fw * 0.5 + pb_ * (1.0 - fw * fw)
    ba = g(c2, 0, 0) + (g(c2, 1, 0) - g(c2, 0, 0)) * fp
    bb = g(c2, 0, 1) + (g(c2, 1, 1) - g(c2, 0, 1)) * fp
    t1 = ba + (bb - ba) * fw
    ca = g(c3, 0, 0) + (g(c3, 1, 0) - g(c3, 0, 0)) * fp
    cb_ = g(c3, 0, 1) + (g(c3, 1, 1) - g(c3, 0, 1)) * fp
    t2 = ca + (cb_ - ca) * fw
    return torch.clamp(ax + (t1 + t2 * x3) * x3, 1e-7, 0.9999999)


def _superlayer_cloud(enn_b, tcld_b, lo, hi):
    """Effective cloudiness of superlayer [lo, hi] for all (k1, k2) pairs.

    Replicates cldovlp/mkicx semantics (irrad.F90:2513-2780): within the
    superlayer, layers are processed in ascending order of enn (stable), with
    the recurrence c <- enn_j + tcld_j * c for layers j in [k1, E(k2)] where
    E(k2) is the deepest layer above k2 with enn >= 0.001 (updates in the
    reference only trigger on such layers).

    enn_b, tcld_b: [ncol, nl]. Returns [ncol, nl, nl+1] effective cloud
    fraction per (k1, k2) pair.
    """
    ncol, nl = enn_b.shape
    dev = enn_b.device
    # each column's superlayer layers in ascending enn, ties in layer order
    js = torch.sort(enn_b[:, lo:hi + 1], dim=1, stable=True).indices + lo

    lay = torch.arange(nl, device=dev)
    in_s = (lay >= lo) & (lay <= hi)
    marker = torch.where((enn_b >= 0.001) & in_s, lay, -1)
    # E[k2] = max marker over layers < k2 ; length nl+1
    emax = torch.cat([torch.full((ncol, 1), -1, dtype=marker.dtype,
                                 device=dev),
                      torch.cummax(marker, dim=1).values], dim=1)

    k1_idx = lay[None, :, None]
    c = torch.zeros((ncol, nl, nl + 1), dtype=enn_b.dtype, device=dev)
    for p in range(js.shape[1]):
        j = js[:, p:p + 1]                                # [ncol, 1]
        m = (j[:, :, None] >= k1_idx) & (j[:, :, None] <= emax[:, None, :])
        enn_j = enn_b.gather(1, j)[:, :, None]
        tcld_j = tcld_b.gather(1, j)[:, :, None]
        c = torch.where(m, enn_j + tcld_j * c, c)
    return c


def _emission(layer_tran, blev, bsum):
    """Eqs. (8.17)-(8.18): down = b_top + (b_top-b_bot)*g(u) with
    u = -log(T_layer), g(u) = 1/u - 1/(1-exp(-u)). The reference's direct
    form (irrad.F90:908-912) cancels catastrophically as T->1; g is
    evaluated via its series there (same limit, stable).
    Returns (up, down), [ncol, nl] each."""
    yy = torch.clamp(layer_tran, 1e-5, 0.9999)
    u = -torch.log(yy)
    w = 1.0 - yy
    g_direct = 1.0 / u - 1.0 / w
    g_series = -0.5 - u / 12.0 + (u * u * u) / 720.0
    g = torch.where(u < 0.1, g_series, g_direct)
    down = blev[:, :-1] + (blev[:, :-1] - blev[:, 1:]) * g
    return bsum - down, down


def _chou_lw_columns(ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4,
                     cfc11, cfc12, cfc22, cwc, fcld, reff, taua, ssaa, asya,
                     *, ict, icb, trace, with_aerosol):
    """Chou LW on a batch of columns (the reference's single-column
    function with the column batch leading every array)."""
    dtype, dev = ta.dtype, ta.device
    ncol, np_ = ta.shape
    t = load("chou_irrad_constants")
    cb = on_device(t["cb"], dev, dtype)
    dcb = on_device(t["dcb"], dev, dtype)
    xkw = t["xkw"]
    xke = t["xke"]
    mw = t["mw"]
    aw = t["aw"]
    bw = t["bw"]
    pm = t["pm"]
    fkw = t["fkw"]     # (6, 9)
    gkw = t["gkw"]     # (6, 3)

    nl = np_ + 1        # extended layers: virtual layer 0 above model top

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    # ---- extended layer quantities (irrad.F90:377-453) ----
    def ext(x):
        return torch.cat([x[:, :1], x], dim=1)

    dp_mod = (ple[:, 1:] - ple[:, :-1]) * 0.01          # hPa
    dp0 = torch.clamp(ple[:, 0] * 0.01, min=0.005)
    dp = torch.cat([dp0[:, None], dp_mod], dim=1)
    pa = torch.cat([(0.5 * dp0)[:, None],
                    0.5 * (ple[:, 1:] + ple[:, :-1]) * 0.01], dim=1)
    ta_e = ext(ta)
    wa_e = ext(wa)
    dt = ta_e - 250.0

    dh2o = torch.clamp(1.02 * wa_e * dp, min=1e-10)
    do3 = torch.clamp(476.0 * ext(oa) * dp, min=1e-6)
    dco2 = torch.clamp(789.0 * ext(co2) * dp, min=1e-4)
    dch4 = 789.0 * ext(ch4) * dp
    dn2o = 789.0 * ext(n2o) * dp
    df11 = 789.0 * ext(cfc11) * dp
    df12 = 789.0 * ext(cfc12) * dp
    df22 = 789.0 * ext(cfc22) * dp
    dcont = (pa * 0.001618 * wa_e * wa_e * dp
             * torch.exp(1800.0 / ta_e - 6.081))

    # ---- cloud optics: 10 bands x extended layers ----
    tcld_m, enn_m, _ = getirtau(ple[:, 1:] - ple[:, :-1], fcld, reff, cwc)
    tcld = torch.cat([ones(ncol, 10, 1), tcld_m], dim=2)    # [ncol, 10, nl]
    enn = torch.cat([zeros(ncol, 10, 1), enn_m], dim=2)

    # ---- aerosol effective optical depth per band (irrad.F90:670-692) ----
    if with_aerosol:
        w_ratio = ssaa / torch.clamp(taua, min=1e-20)
        g_ratio = asya / torch.clamp(ssaa, min=1e-20)
        ffa = 0.5 + (0.3739 + (0.0076 + 0.1185 * g_ratio) * g_ratio) \
            * g_ratio
        tau_scaled = torch.where(ssaa > 0.001, taua * (1.0 - w_ratio * ffa),
                                 taua)
        taua_eff = torch.where(taua > 0.001, tau_scaled, 0.0)  # [n, np, 10]
        taua_eff = torch.cat([zeros(ncol, 1, 10), taua_eff], dim=1)

    # ---- surface (homogeneous, no vegetation; irrad.F90:2662-2670) ----
    bg = _planck_all_bands(cb, ts)          # [ncol, 10]
    dbg = _plancd_all_bands(dcb, ts)
    bs_b = emis * bg
    dbs_b = emis * dbg
    rflxs_b = 1.0 - emis

    # ---- Planck profiles per band ----
    blayer = _planck_all_bands(cb, ta_e).transpose(1, 2)   # [ncol, 10, nl]
    bsurf_lev = _planck_all_bands(cb, tb)   # blevel(np+1) from surface air T

    # blevel [ncol, 10, nl+1]: levels 0..np+1 (extended level j corresponds
    # to Fortran level j; level 0 == level 1)
    dpm = dp_mod[:, None, :]
    inner = ((blayer[..., 1:-1] * dpm[..., 1:]
              + blayer[..., 2:] * dpm[..., :-1])
             / (dpm[..., :-1] + dpm[..., 1:]))           # levels 2..np
    blev1 = (blayer[..., 1] + (blayer[..., 1] - blayer[..., 2])
             * dpm[..., 0] / (dpm[..., 0] + dpm[..., 1]))   # level 1
    blevel = torch.cat([blev1[..., None], blev1[..., None], inner,
                        bsurf_lev[..., None]], dim=2)

    # ---- path-sum building blocks ----
    lay = torch.arange(nl + 1, device=dev)
    tri = lay[None, :] > lay[:nl, None]                   # k2 > k1

    d_cont = _pair_delta(dcont)

    # table-band path sums (s1, s2, s3) per gas
    def tab_paths(dw):
        return (_pair_delta(dw), _pair_delta(pa * dw), _pair_delta(dt * dw))

    # scaled k-distribution amounts (Eq. 4.4 scalings, irrad.F90:1425-1457)
    def h2o_scaled(ib):
        return dh2o * (pa / 500.0) ** float(pm[ib - 1]) \
            * (1.0 + (float(aw[ib - 1]) + float(bw[ib - 1]) * dt) * dt)

    def expneg(k, d):
        return torch.exp(-float(k) * torch.clamp(d, min=0.0))

    flxu = zeros(ncol, nl + 1)
    flcu = zeros(ncol, nl + 1)
    flau = zeros(ncol, nl + 1)
    flxau = zeros(ncol, nl + 1)
    flxd = zeros(ncol, nl + 1)
    flcd = zeros(ncol, nl + 1)
    flad = zeros(ncol, nl + 1)
    flxad = zeros(ncol, nl + 1)
    dfdts = zeros(ncol, nl + 1)
    sfcem = zeros(ncol)
    z1 = zeros(ncol, 1)
    o1 = ones(ncol, 1)

    nbands = 10 if trace else 9
    for ib in range(1, nbands + 1):
        bi = ib - 1
        b10 = ib == 10

        # ---- gas transmittance for all pairs ----
        taant = torch.ones((ncol, nl, nl + 1), dtype=dtype, device=dev)
        if ib in (1, 2, 8):
            pre = {1: "h1", 2: "h2", 8: "h8"}[ib]
            s1, s2, s3 = tab_paths(dh2o)
            taant = taant * _tablup(
                s1, s2, s3, t[pre + "1"], t[pre + "2"], t[pre + "3"],
                t["w11"], t["p11"], t["dwe"], t["dpe"])
            if ib == 2:
                taant = taant * expneg(xke[1], d_cont)
        elif not b10:
            du = _pair_delta(h2o_scaled(ib))
            if ib == 3:
                # 3 sub-bands with separate continuum scalings (gkw)
                trn = 0.0
                for sub in range(3):
                    line = _kdist_tran(du, xkw[2], float(mw[2]),
                                       gkw[:, sub])
                    con = expneg(xke[2] * (2.0 ** sub), d_cont)
                    trn = trn + line * con
                taant = taant * trn
            else:
                trn = _kdist_tran(du, xkw[bi], float(mw[bi]), fkw[:, bi])
                if 2 <= ib <= 7:
                    trn = trn * expneg(xke[bi], d_cont)
                taant = taant * trn
        if ib == 3:
            s1, s2, s3 = tab_paths(dco2)
            taant = taant * _tablup(
                s1, s2, s3, t["c1"], t["c2"], t["c3"],
                t["w12"], t["p12"], t["dwe"], t["dpe"])
        if ib == 5:
            s1, s2, s3 = tab_paths(do3)
            taant = taant * _tablup(
                s1, s2, s3, t["oo1"], t["oo2"], t["oo3"],
                t["w13"], t["p13"], t["dwe"], t["dpe"])

        if trace:
            if ib in (6, 7):
                if ib == 6:
                    un2o = dn2o * (1.0 + (1.9297e-3 + 4.3750e-6 * dt) * dt)
                else:
                    un2o = dn2o * (pa / 500.0) ** 0.48 \
                        * (1.0 + (1.3804e-3 + 7.4838e-6 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(un2o), _N2O_K[ib], _N2O_POW[ib], _N2O_W[ib])
                if ib == 6:
                    uch4 = dch4 * (1.0 + (1.7007e-2 + 1.5826e-4 * dt) * dt)
                else:
                    uch4 = dch4 * (pa / 500.0) ** 0.65 \
                        * (1.0 + (5.9590e-4 - 2.2931e-6 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(uch4), _CH4_K[ib], _CH4_POW[ib], _CH4_W[ib])
            if ib in (4, 5):
                if ib == 4:
                    ucom = dco2 * (1.0 + (3.5775e-2 + 4.0447e-4 * dt) * dt)
                else:
                    ucom = dco2 * (1.0 + (3.4268e-2 + 3.7401e-4 * dt) * dt)
                taant = taant * _kdist_tran(
                    _pair_delta(ucom), _COM_K, 5.0, _COM_W[ib])
            for gas, dcfc in (("f11", df11), ("f12", df12), ("f22", df22)):
                bands = {"f11": (4, 5), "f12": (4, 6), "f22": (4, 6)}[gas]
                if ib in bands:
                    a1, b1, fk1, a2, b2, fk2 = _CFC_PARAMS[gas]
                    if ib == 4:
                        ucfc = dcfc * (1.0 + (a1 + b1 * dt) * dt)
                        fk = fk1
                    else:
                        ucfc = dcfc * (1.0 + (a2 + b2 * dt) * dt)
                        fk = fk2
                    taant = taant * expneg(fk, _pair_delta(ucfc))
            if b10:
                uh2o = dh2o * (pa / 500.0) \
                    * (1.0 + (0.0149 + 6.20e-5 * dt) * dt)
                uco2 = dco2 * (pa / 300.0) ** 0.5 \
                    * (1.0 + (0.0179 + 1.02e-4 * dt) * dt)
                un2o = dn2o * (1.0 + (1.4476e-3 + 3.6656e-6 * dt) * dt)
                th2o = _kdist_tran(_pair_delta(uh2o), 0.10624, 8.0,
                                   _B10_H2O_W)
                tcon = expneg(109.0, d_cont)
                tco2 = _kdist_tran(_pair_delta(uco2), 2.656e-5, 8.0,
                                   _B10_CO2_W)
                tn2o = _kdist_tran(_pair_delta(un2o), 0.25238, 58.0,
                                   _B10_N2O_W)
                taant = th2o * tcon * tco2 * (tn2o - 1.0)

        # ---- aerosol ----
        if with_aerosol:
            trant = taant * expneg(DIFFUSIVITY,
                                   _pair_delta(taua_eff[:, :, bi]))
        else:
            trant = taant

        # ---- cloud overlap: fclr for all pairs ----
        enn_b = enn[:, bi]
        tcld_b = tcld[:, bi]
        c_hi = _superlayer_cloud(enn_b, tcld_b, 0, ict - 1)
        c_md = _superlayer_cloud(enn_b, tcld_b, ict, icb - 1)
        c_lw = _superlayer_cloud(enn_b, tcld_b, icb, nl - 1)
        fclr = (1.0 - c_hi) * (1.0 - c_md) * (1.0 - c_lw)
        del c_hi, c_md, c_lw

        # ---- layer emissions (irrad.F90:804-945) ----
        if b10:
            lay_tr = ones(ncol, nl)
            lay_ta = lay_tr
        else:
            # trant(k, k+1)
            lay_tr = torch.diagonal(trant, offset=1, dim1=-2, dim2=-1)
            lay_ta = torch.diagonal(taant, offset=1, dim1=-2, dim2=-1)

        blev = blevel[:, bi]       # [ncol, nl+1]
        bsum = blev[:, :-1] + blev[:, 1:]

        bu_l, bd_l = _emission((1.0 - enn_b) * lay_tr, blev, bsum)
        cu_l, cd_l = _emission(lay_tr, blev, bsum)
        if with_aerosol:
            du_l, dd_l = _emission((1.0 - enn_b) * lay_ta, blev, bsum)
            au_l, ad_l = _emission(lay_ta, blev, bsum)
        else:
            du_l, dd_l = bu_l, bd_l
            au_l, ad_l = cu_l, cd_l

        bsfc = bs_b[:, bi:bi + 1]             # [ncol, 1]

        def with_sfc(x):                      # index 0..np+1
            return torch.cat([x, bsfc], dim=1)

        bu, bd = with_sfc(bu_l), with_sfc(bd_l)
        cu, cd = with_sfc(cu_l), with_sfc(cd_l)
        du_, dd = with_sfc(du_l), with_sfc(dd_l)
        au, ad = with_sfc(au_l), with_sfc(ad_l)

        # ---- flux accumulation over pairs (irrad.F90:1210-1277) ----
        trant_fclr = trant * fclr
        taant_fclr = taant * fclr
        w_all = torch.where(tri, trant_fclr, 0.0)
        w_all_na = torch.where(tri, taant_fclr, 0.0)
        w_clr = torch.where(tri, trant, 0.0)
        w_clr_na = torch.where(tri, taant, 0.0)

        def dvec_up(u):
            return u[:, :-1] - u[:, 1:]   # entry j is the k2=j+1 term

        def dvec_dn(d):
            # index k1=0..np: k1=0 -> -bd(0); else bd(k1-1)-bd(k1)
            return torch.cat([-d[:, :1], d[:, :-2] - d[:, 1:-1]], dim=1)

        def upsum(w, dx):
            # pair k2 axis is 0..np+1; k2>=1 contributes dx[k2-1]; the
            # upward flux is indexed by k1=0..np, pad level np+1 with 0
            s = (w[:, :, 1:] * dx[:, None, :]).sum(dim=2)
            return torch.cat([s, z1], dim=1)

        def dnsum(w, dx):
            return (w * dx[:, :, None]).sum(dim=1)

        flxu_b = upsum(w_all, dvec_up(bu))
        flxau_b = upsum(w_all_na, dvec_up(du_))
        flcu_b = upsum(w_clr, dvec_up(cu))
        flau_b = upsum(w_clr_na, dvec_up(au))

        flxd_b = dnsum(w_all, dvec_dn(bd))
        flxad_b = dnsum(w_all_na, dvec_dn(dd))
        flcd_b = dnsum(w_clr, dvec_dn(cd))
        flad_b = dnsum(w_clr_na, dvec_dn(ad))
        del w_all, w_all_na, w_clr, w_clr_na

        # boundary (k2 == k1+1) terms, bands != 10 (irrad.F90:1212-1221)
        if not b10:
            flxu_b = flxu_b - torch.cat([bu[:, :-1], z1], dim=1)
            flxau_b = flxau_b - torch.cat([du_[:, :-1], z1], dim=1)
            flcu_b = flcu_b - torch.cat([cu[:, :-1], z1], dim=1)
            flau_b = flau_b - torch.cat([au[:, :-1], z1], dim=1)
            flxd_b = flxd_b + torch.cat([z1, bd[:, :-1]], dim=1)
            flxad_b = flxad_b + torch.cat([z1, dd[:, :-1]], dim=1)
            flcd_b = flcd_b + torch.cat([z1, cd[:, :-1]], dim=1)
            flad_b = flad_b + torch.cat([z1, ad[:, :-1]], dim=1)

        # surface-to-level transmittances (irrad.F90:1279-1285)
        trantcr = torch.cat([trant[:, :, -1], o1], dim=1)
        trantca = torch.cat([taant[:, :, -1], o1], dim=1)
        transfc = torch.cat([trant_fclr[:, :, -1], o1], dim=1)
        transfca = torch.cat([taant_fclr[:, :, -1], o1], dim=1)
        del trant, taant, trant_fclr, taant_fclr, fclr

        # dfdts for levels 1..np (irrad.F90:1291-1293); all bands
        dbs = dbs_b[:, bi:bi + 1]
        lev_mask = torch.cat([z1, ones(ncol, nl - 1), z1], dim=1)
        dfdts = dfdts - dbs * transfc * lev_mask

        if not b10:
            # surface emission & reflection (irrad.F90:1298-1319)
            flxu_b = torch.cat([flxu_b[:, :-1], -bsfc], dim=1)
            flxau_b = torch.cat([flxau_b[:, :-1], -bsfc], dim=1)
            flcu_b = torch.cat([flcu_b[:, :-1], -bsfc], dim=1)
            flau_b = torch.cat([flau_b[:, :-1], -bsfc], dim=1)
            sfcem = sfcem - bsfc[:, 0]
            dfdts = torch.cat([dfdts[:, :-1], dfdts[:, -1:] + (-dbs)], dim=1)

            rfl = rflxs_b[:, bi:bi + 1]
            refl_mask = torch.cat([z1, ones(ncol, nl)], dim=1)
            flau_b = flau_b - flad_b[:, -1:] * trantca * rfl * refl_mask
            flcu_b = flcu_b - flcd_b[:, -1:] * trantcr * rfl * refl_mask
            flxu_b = flxu_b - flxd_b[:, -1:] * transfc * rfl * refl_mask
            flxau_b = flxau_b - flxad_b[:, -1:] * transfca * rfl * refl_mask

        flxu = flxu + flxu_b
        flxau = flxau + flxau_b
        flcu = flcu + flcu_b
        flau = flau + flau_b
        flxd = flxd + flxd_b
        flxad = flxad + flxad_b
        flcd = flcd + flcd_b
        flad = flad + flad_b

    # drop the virtual index 0; model levels are 1..np+1
    return dict(
        flxu=flxu[:, 1:], flxd=flxd[:, 1:], flcu=flcu[:, 1:],
        flcd=flcd[:, 1:], flau=flau[:, 1:], flad=flad[:, 1:],
        flxau=flxau[:, 1:], flxad=flxad[:, 1:], dfdts=dfdts[:, 1:],
        sfcem=sfcem)


def chou_lw_eager(ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4,
                  cfc11, cfc12, cfc22, cwc, fcld, reff,
                  taua=None, ssaa=None, asya=None, *,
                  ict, icb, trace=True, with_aerosol=False):
    """Batched Chou-Suarez LW fluxes, run op by op.

    Args:
      ple:   [ncol, np+1] level pressure (Pa), TOA..surface
      ta:    [ncol, np] layer temperature (K)
      wa:    [ncol, np] specific humidity (g/g)
      oa:    [ncol, np] ozone mass mixing ratio (g/g)
      tb:    [ncol] surface air temperature (K)
      ts:    [ncol] skin temperature (K)
      emis:  [ncol, 10] surface emissivity per band
      co2, n2o, ch4, cfc11, cfc12, cfc22: [ncol, np] volume mixing ratios
      cwc:   [ncol, np, 4] hydrometeor mixing ratios (ice, liq, rain, snow)
      fcld:  [ncol, np] cloud fraction
      reff:  [ncol, np, 4] effective radii (micron)
      taua/ssaa/asya: [ncol, np, 10] aerosol optics per band (optional)
      ict, icb: level indices separating high/mid and mid/low clouds
                (1-based, matching the reference's LCLDMH/LCLDLM)
      trace: include trace gases (band 10, N2O/CH4/CFCs)

    The columns are solved CHUNK at a time (the pair planes of one band
    are [CHUNK, np+1, np+2]).

    Returns dict of [ncol, np+1] level fluxes (W/m^2; up negative, down
    positive): flxu/flxd (all-sky), flcu/flcd (clear), flau/flad (clear,
    no aerosol), flxau/flxad (all-sky, no aerosol), dfdts [ncol, np+1],
    sfcem [ncol].
    """
    ncol, np_ = ta.shape
    if taua is None:
        taua = torch.zeros((ncol, np_, 10), dtype=ta.dtype, device=ta.device)
        ssaa = torch.zeros_like(taua)
        asya = torch.zeros_like(taua)
    args = (ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4, cfc11, cfc12,
            cfc22, cwc, fcld, reff, taua, ssaa, asya)
    kw = dict(ict=ict, icb=icb, trace=trace, with_aerosol=with_aerosol)
    parts = [_chou_lw_columns(*(a[i:i + CHUNK] for a in args), **kw)
             for i in range(0, ncol, CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


chou_lw = captured(chou_lw_eager,
                   static_argnames=("ict", "icb", "trace", "with_aerosol"))
chou_lw.__doc__ = """Batched Chou-Suarez LW fluxes (chou_lw_eager's
arguments and results), as a CUDA graph captured once per static key on
a card (the reference's static argnames, models/chou_lw.py:547); CPU
tensors run the body eagerly."""
