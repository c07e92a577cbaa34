"""ISCCP cloud simulator (icarus).

Port of geosradiation_gridcomp_tpu/satsim/icarus.py (icarus.f:1-1273):
every loop over (points, subcolumns) is vectorized; the TOA radiance
accumulations are exclusive cumulative products over the level axis; the
brightness-temperature/pressure level match is a masked arg-reduction
instead of a serial search. The 10.5-micron water-vapor continuum follows
Schwarzkopf & Ramaswamy (icarus.f:125 block), the partially-transmitting
cloud-top adjustment and the tau/CTP histogram the ISCCP D-series
documentation as coded in the reference.

All level arrays are TOA-first ([..., 0] = top), like the reference.
"""

import numpy as np
import torch

from ..tables import on_device

# ISCCP 7x7 histogram bin edges (icarus.f:995-1046)
TAU_EDGES = np.array([0.3, 1.3, 3.6, 9.4, 23.0, 60.0])    # itau 1..7
PTOP_EDGES = np.array([180., 310., 440., 560., 680., 800.])  # ipres (mb)
ISCCP_TAUMIN = 0.3
MISSING = -1.0e30
_TAUCHK = float(-np.log(0.9999999))
_B0 = 1307.27          # Planck exponent at 10.5 micron (icarus radiances)


def digitize(x, edges):
    """numpy/jnp digitize over increasing edges (bins[i-1] <= x <
    bins[i]), the edges taken to x's dtype as the reference does (on x's
    device once, tables.on_device)."""
    e = on_device(edges, x.device, x.dtype)
    return torch.searchsorted(e, x.contiguous(), right=True)


def histogram(cell, weight, ncell):
    """Per point, the count of each of ncell cells over the subcolumns
    where weight holds: cell, weight [np, ncol] -> [np, ncell] int64."""
    onehot = cell[..., None] == torch.arange(ncell, device=cell.device)
    return (onehot & weight[..., None]).sum(dim=1)


def _bb(t):
    """Normalized 10.5-micron Planck radiance (icarus.f bb)."""
    return 1.0 / torch.expm1(_B0 / t)


def _inv_bb(f):
    """Brightness temperature from normalized radiance."""
    return _B0 / torch.log1p(1.0 / torch.clamp(f, min=1e-30))


def water_vapor_emissivity(pfull, phalf, qv, at):
    """10.5-micron water-vapor continuum emissivity per layer
    (icarus.f clear-sky block; Schwarzkopf & Ramaswamy JGR 1999)."""
    wtmair, wtmh20 = 28.9644, 18.01534
    navo, grav = 6.023e23, 9.806650e2
    pstd, t0 = 1.013250e6, 296.0
    press = pfull * 10.0                      # dyne/cm^2
    dpress = (phalf[..., 1:] - phalf[..., :-1]) * 10.0
    atmden = dpress / grav
    rvh20 = qv * wtmair / wtmh20
    wk = rvh20 * navo * atmden / wtmair
    rhoave = (press / pstd) * (t0 / at)
    rh20s = rvh20 * rhoave
    rfrgn = rhoave - rh20s
    tmpexp = torch.exp(-0.02 * (at - t0))
    tauwv = wk * 1e-20 * (0.0224697 * rh20s * tmpexp
                          + 3.41817e-7 * rfrgn) * 0.98
    return -torch.expm1(-tauwv)


def _toa_radiance(dem, bb, sfc_bb, emsfc):
    """TOA 10.5-micron radiance from per-layer emissivities.

    fluxtop = sum_l dem_l * bb_l * prod_{k<l}(1-dem_k)
            + emsfc * bb_sfc * prod_all(1-dem).
    dem/bb: [..., nlev]; returns [...]."""
    trans = torch.cumprod(1.0 - dem, dim=-1)
    trans_above = torch.cat([torch.ones_like(trans[..., :1]),
                             trans[..., :-1]], dim=-1)
    return ((dem * bb * trans_above).sum(dim=-1)
            + emsfc * sfc_bb * trans[..., -1])


def isccp_simulator(frac_out, pfull, phalf, qv, at, skt, emsfc_lw,
                    dtau_s, dtau_c, dem_s, dem_c, sunlit,
                    top_height=1, top_height_direction=2):
    """ISCCP cloud-type diagnostics from sampled subcolumns.

    Args:
      frac_out: [np, ncol, nlev] int (0/1/2) from scops.
      pfull/at/qv/dtau_*/dem_*: [np, nlev]; phalf: [np, nlev+1] (Pa).
      skt: [np] skin temperature; emsfc_lw: scalar surface emissivity.
      sunlit: [np] 1/0.
      top_height: 1 = VIS/IR adjusted ptop, 2 = model ptop, 3 = IR-only.
      top_height_direction: 1 lowest / 2 highest altitude temperature
        match (icarus.f:104-123).

    Returns dict: fq_isccp [np, 7, 7] (tau x ptop), totalcldarea,
    meanptop, meantaucld, meanalbedocld, meantb, meantbclr [np],
    boxtau/boxptop [np, ncol].
    """
    npnt, ncol, nlev = frac_out.shape
    dtype, dev = pfull.dtype, pfull.device
    adjust = top_height in (1, 3)
    zero = torch.zeros((), dtype=dtype, device=dev)
    missing = torch.full((), MISSING, dtype=dtype, device=dev)

    # per-subcolumn visible optical depth (icarus.f tau accumulation)
    tau = (torch.where(frac_out == 1, dtau_s[:, None, :], zero)
           + torch.where(frac_out == 2, dtau_c[:, None, :], zero)).sum(-1)

    if adjust:
        # tropopause: min temperature in 50-400 hPa (icarus.f:12 loop)
        in_trop = (pfull < 40000.0) & (pfull > 5000.0)
        at_masked = torch.where(in_trop, at, torch.full_like(at, 400.0))
        itrop = torch.argmin(at_masked, dim=-1)
        has_trop = in_trop.any(dim=-1)
        attrop = torch.where(has_trop, at_masked.min(dim=-1).values,
                             torch.full_like(at[:, 0], 120.0))
        ptrop = torch.where(
            has_trop, torch.take_along_dim(pfull, itrop[:, None], -1)[:, 0],
            torch.full_like(at[:, 0], 5000.0))
        lev_idx = torch.arange(nlev, device=dev)[None, :]
        atmax = torch.where(lev_idx >= itrop[:, None], at, zero).max(
            dim=-1).values

        dem_wv = water_vapor_emissivity(pfull, phalf, qv, at)
        bb_lay = _bb(at)
        bb_sfc = _bb(skt)
        flux_clr = _toa_radiance(dem_wv, bb_lay, bb_sfc, emsfc_lw)
        meantbclr = _inv_bb(flux_clr)

        # all-sky per-subcolumn radiance: combined cloud+wv emissivity
        demwv_x = dem_wv[:, None, :]
        dem = torch.where(
            frac_out == 1,
            1.0 - (1.0 - demwv_x) * (1.0 - dem_s[:, None, :]),
            torch.where(frac_out == 2,
                        1.0 - (1.0 - demwv_x) * (1.0 - dem_c[:, None, :]),
                        demwv_x))
        fluxtop = _toa_radiance(dem, bb_lay[:, None, :], bb_sfc[:, None],
                                emsfc_lw)
        meantb = _inv_bb(fluxtop).mean(dim=-1)

        # partially-transmitting cloud adjustment (icarus.f:~700 block)
        btcmin = _bb(attrop - 5.0)[:, None]
        transmax = torch.where(
            flux_clr[:, None] != btcmin,
            (fluxtop - btcmin) / (flux_clr[:, None] - btcmin),
            torch.ones_like(fluxtop))
        tauir = tau / 2.13
        taumin = -torch.log(torch.clamp(transmax, 0.001, 0.9999999))
        if top_height == 1:
            in_range = (transmax > 0.001) & (transmax <= 0.9999999)
            fluxtopinit = fluxtop
            ftop = fluxtop
            for _ in range(2):       # two fixed-point cycles (icycle)
                emcld = -torch.expm1(-tauir)
                fnew = fluxtopinit - (1.0 - emcld) * flux_clr[:, None]
                fnew = torch.clamp(fnew / torch.clamp(emcld, min=1e-12),
                                   min=1e-6)
                apply = (tau > _TAUCHK) & in_range
                ftop = torch.where(apply, fnew, ftop)
                tb_i = _inv_bb(ftop)
                tauir = torch.where(apply & (tb_i > 260.0), tau / 2.56,
                                    tauir)
            fluxtop = ftop
        tb = torch.where(tau > _TAUCHK, _inv_bb(fluxtop),
                         meantbclr[:, None])
        if top_height == 1:
            frozen = (tau > _TAUCHK) & (tauir < taumin)
            tb = torch.where(frozen, (attrop - 5.0)[:, None], tb)
            tau = torch.where(frozen, 2.13 * taumin, tau)

        # level whose temperature matches tb, at/below the tropopause
        # (icarus.f "30" loop): bracket tests on consecutive levels
        at1 = at[:, None, :-1]         # [np, 1, nlev-1]
        at2 = at[:, None, 1:]
        tbx = tb[..., None]
        bracket = (((at1 >= tbx) & (at2 <= tbx))
                   | ((at1 <= tbx) & (at2 >= tbx)))
        k_idx = torch.arange(nlev - 1, device=dev)[None, None, :]
        bracket = bracket & (k_idx >= itrop[:, None, None])
        has_match = bracket.any(dim=-1)
        # argmax of a bool is not defined on the card: cast first
        if top_height_direction == 2:
            # last match scanning upward = lowest k (highest altitude)
            kmatch = torch.argmax(bracket.to(torch.int8), dim=-1)
        else:
            kmatch = (nlev - 2) - torch.argmax(
                bracket.flip(-1).to(torch.int8), dim=-1)
        km = kmatch[..., None]
        pf = pfull[:, None, :].expand(npnt, ncol, nlev)
        af = at[:, None, :].expand(npnt, ncol, nlev)
        p1 = torch.take_along_dim(pf, km, -1)
        p2 = torch.take_along_dim(pf, km + 1, -1)
        t1 = torch.take_along_dim(af, km, -1)
        t2 = torch.take_along_dim(af, km + 1, -1)
        atd = torch.clamp((t2 - t1).abs(), min=_TAUCHK)
        logp = torch.log(p1) + (torch.log(p2) - torch.log(p1)) \
            * (tbx - t1).abs() / atd
        ptop_m = torch.exp(logp)[..., 0]
        ptop = torch.where(
            has_match, ptop_m,
            torch.where(tb <= attrop[:, None], ptrop[:, None],
                        torch.where(tb >= atmax[:, None], pfull[:, -1:],
                                    zero)))
    else:
        # top_height == 2: model cloud-top pressure = highest cloudy level
        cloudy_lev = frac_out != 0
        first = torch.argmax(cloudy_lev.to(torch.int8), dim=-1)
        anyc = cloudy_lev.any(dim=-1)
        ph = phalf[:, None, :].expand(npnt, ncol, nlev + 1)
        ptop = torch.where(anyc, torch.take_along_dim(
            ph, first[..., None], -1)[..., 0], zero)
        meantb = torch.full((npnt,), MISSING, dtype=dtype, device=dev)
        meantbclr = meantb

    ptop = torch.where(tau <= _TAUCHK, zero, ptop)
    box_cloudy = (tau > _TAUCHK) & (ptop > 0.0)
    ptop_mb = ptop / 100.0

    # visibility of diagnostics: daytime only unless IR-only mode
    seen = (sunlit == 1) if top_height != 3 \
        else torch.ones(npnt, dtype=torch.bool, device=dev)
    boxarea = 1.0 / ncol

    thick = box_cloudy & (tau >= ISCCP_TAUMIN)
    albedocld = torch.where(thick, tau ** 0.895 / (tau ** 0.895 + 6.82),
                            zero)
    totalcldarea = thick.sum(dim=-1) * boxarea
    meanalbedocld = albedocld.sum(dim=-1) * boxarea
    meanptop = torch.where(thick, ptop_mb, zero).sum(dim=-1) * boxarea

    # 7x7 joint histogram: itau x ipres one-hot accumulation
    cell = digitize(tau, TAU_EDGES) * 7 + digitize(ptop_mb, PTOP_EDGES)
    fq = histogram(cell, box_cloudy, 49) * boxarea
    fq_isccp = fq.reshape(npnt, 7, 7)

    # in-cloud means (only over tau >= taumin area)
    pos = totalcldarea > 0.0
    area = torch.clamp(totalcldarea, min=1e-12)
    meanptop = torch.where(pos, meanptop / area, missing)
    meanalb = torch.where(pos, meanalbedocld / area, missing)
    meantaucld = torch.where(
        pos, (6.82 / (1.0 / torch.clamp(meanalb, 1e-6, 1 - 1e-6) - 1.0))
        ** (1.0 / 0.895), missing)

    def mask1(x):
        return torch.where(seen, x, missing)
    return dict(
        fq_isccp=torch.where(seen[:, None, None], fq_isccp, missing),
        totalcldarea=mask1(totalcldarea),
        meanptop=mask1(meanptop), meantaucld=mask1(meantaucld),
        meanalbedocld=mask1(meanalb),
        meantb=mask1(meantb) if adjust else meantb,
        meantbclr=mask1(meantbclr) if adjust else meantbclr,
        boxtau=torch.where(box_cloudy, tau, missing),
        boxptop=torch.where(box_cloudy, ptop_mb, missing))
