"""Native RRTMGP gas-optics engine: generic T/p/eta interpolation.

Port of geosradiation_gridcomp_tpu/models/rrtmgp/gas_optics.py, in plain
PyTorch (the reference leaves it to XLA): an engine that consumes an
ARBITRARY k-distribution coefficient set (any number of bands, g-points,
gases, flavors and minor contributors) and computes optical depths by
trilinear interpolation in (temperature, eta, log-pressure), plus Planck
sources (LW) or solar source + Rayleigh (SW). The per-layer index math is
vectorized over [ncol, nlay]; the coefficient fetches are row gathers
over the flattened (temp, eta, press) grid with the g-axis last; the
flavors and minor contributors are host loops over the static metadata.
Each g-point group is interpolated on its own g-points only.

Data (load_kdist_npz in kdist.py): the schema below, the coefficient
tables (kmajor, planck_frac, totplnk, rayl, solar_src, kminor) as
float32 tensors on the device, the metadata as numpy; the index arrays
and ratios derived from the metadata go to the device once per value
and device (tables.on_device), so a call copies nothing from host
memory.

Schema (0-based gas indices; gas 0 == dry air):
  press_ref [npress] Pa descending; temp_ref [ntemp] K ascending
  press_ref_trop: scalar Pa
  vmr_ref [2, ngas+1, ntemp]  (itropo: 0 lower, 1 upper)
  flavor [nflav, 2] gas indices (1-based into the gas list, 0 = dry)
  gpoint_flavor [2, ngpt] flavor index (1-based) per (itropo, gpt)
  kmajor [ntemp, neta, npress+1, ngpt]
  band_lims_gpt [nbnd, 2] 1-based inclusive; band_lims_wvn [nbnd, 2]
  minor_lower/minor_upper: dicts with
      kminor [ntemp, neta, ngpt_m_total]
      gpt_limits [nmin, 2] (1-based, into the full gpt axis)
      gas_idx [nmin] (1-based gas), scales_with_density [nmin] bool,
      scaling_gas [nmin] (0 none, else 1-based gas),
      scale_by_complement [nmin] bool
  LW: totplnk [npt, nbnd], planck_frac [ntemp, neta, npress+1, ngpt],
      temp_ref_planck [npt]
  SW: solar_src [ngpt], rayl [2, ntemp, neta, ngpt]
"""

import numpy as np
import torch

from ...tables import on_device

PA2HPA = 0.01
M_DRY = 0.028964
M_H2O = 0.018016
AVOGAD = 6.02214076e23
GRAV = 9.80665


# ---------------------------------------------------------------------
# column amounts
# ---------------------------------------------------------------------

def column_gas(plev_pa, vmr, h2ovmr):
    """Column amount [molec/cm^2] of a gas with vmr [ncol, nlay], and the
    dry-air column.

    RRTMGP molec/cm^2 convention (rte-rrtmgp get_col_dry): moist-air
    molar mass, then divide the total column by (1 + h2ovmr) for the
    dry-air count.
    """
    dp = torch.abs(plev_pa[:, 1:] - plev_pa[:, :-1])
    m_air = (M_DRY + M_H2O * h2ovmr) / (1.0 + h2ovmr)
    col_dry = dp / (GRAV * m_air) * AVOGAD * 1e-4 / (1.0 + h2ovmr)
    return col_dry * vmr, col_dry


# ---------------------------------------------------------------------
# interpolation state
# ---------------------------------------------------------------------

class InterpState:
    """Per-layer interpolation indices/weights (mo_gas_optics_kernels::
    interpolation equivalent), flavors resolved statically."""

    def __init__(self, data, play_pa, tlay, col_gas):
        press_ref = np.asarray(data["press_ref"], np.float64)
        temp_ref = np.asarray(data["temp_ref"], np.float64)
        npress = press_ref.size
        ntemp = temp_ref.size
        self.neta = int(data["kmajor"].shape[1])
        log_p_ref = np.log(press_ref)
        dlogp = float(log_p_ref[1] - log_p_ref[0])       # negative
        dtemp = float(temp_ref[1] - temp_ref[0])
        t0, logp0 = float(temp_ref[0]), float(log_p_ref[0])

        logp = torch.log(play_pa)
        jt = torch.clamp(torch.floor((tlay - t0) / dtemp).to(torch.int32),
                         0, ntemp - 2)
        self.ftemp = (tlay - (t0 + jt * dtemp)) / dtemp
        self.jtemp = jt                                   # 0-based low
        jp = torch.clamp(torch.floor((logp - logp0) / dlogp).to(torch.int32),
                         0, npress - 2)
        self.fpress = (logp - (logp0 + jp * dlogp)) / dlogp
        self.jpress = jp
        self.tropo = play_pa > float(data["press_ref_trop"])  # lower atm
        self.col_gas = col_gas            # [ngas+1][ncol, nlay]
        self.ncol, self.nlay = tlay.shape

        vmr_ref = np.asarray(data["vmr_ref"], np.float64)
        flavor = np.asarray(data["flavor"], np.int64)
        self.nflav = flavor.shape[0]
        # per (flavor, temp-side): eta interpolation state
        self.jeta, self.feta, self.col_mix = [], [], []
        for fl in range(self.nflav):
            g1, g2 = int(flavor[fl, 0]), int(flavor[fl, 1])
            # ratio of reference vmrs at the bracketing temps,
            # tropo-dependent
            r_low = on_device(
                vmr_ref[0, g1] / np.maximum(vmr_ref[0, g2], 1e-60),
                tlay.device, tlay.dtype)
            r_upp = on_device(
                vmr_ref[1, g1] / np.maximum(vmr_ref[1, g2], 1e-60),
                tlay.device, tlay.dtype)
            jeta_t, feta_t, cmix_t = [], [], []
            for dt in range(2):
                j = torch.clamp(self.jtemp + dt, 0, ntemp - 1).long()
                ratio = torch.where(self.tropo, r_low[j], r_upp[j])
                cmix = col_gas[g1] + ratio * col_gas[g2]
                eta = torch.where(cmix > 2e-60, col_gas[g1]
                                  / torch.clamp(cmix, min=1e-60),
                                  torch.full_like(cmix, 0.5))
                loceta = eta * (self.neta - 1)
                je = torch.clamp(loceta.to(torch.int32), max=self.neta - 2)
                jeta_t.append(je)
                feta_t.append(loceta - je)
                cmix_t.append(cmix)
            self.jeta.append(jeta_t)
            self.feta.append(feta_t)
            self.col_mix.append(cmix_t)

    def fminor(self, fl, dt):
        """2-point eta weights scaled by the temp weight."""
        wt = (1.0 - self.ftemp) if dt == 0 else self.ftemp
        fe = self.feta[fl][dt]
        return (1.0 - fe) * wt, fe * wt


def _gather_rows(tab_flat, idx):
    """tab_flat [R, ng]; idx [ncol, nlay] -> [ncol, nlay, ng]."""
    return tab_flat[idx.long()]


def _flavor_groups(gpt_flavor, itropos):
    """g-points grouped by their flavors (0-based) in the rows itropos of
    gpoint_flavor, as {flavors: int64 g-point index array}; usually one
    group per band."""
    groups = {}
    for g in range(gpt_flavor.shape[1]):
        key = tuple(int(gpt_flavor[i, g]) - 1 for i in itropos)
        groups.setdefault(key, []).append(g)
    return {k: np.asarray(v, np.int64) for k, v in groups.items()}


def _interp3(st, tab, gs, fl_low, fl_upp, with_cmix):
    """Trilinear (temp, eta, press) interpolation of tab [ntemp, neta,
    npress+1, ngpt] on the g-points gs, the flavor lower or upper by
    layer; with_cmix scales by the flavor's column mix (tau_major) or not
    (planck fractions). Returns [ncol, nlay, len(gs)]."""
    ntemp, neta, npp, _ = tab.shape
    gsel = on_device(gs, tab.device)
    flat = tab.reshape(ntemp * neta * npp, -1)[:, gsel]
    p0 = st.jpress + torch.where(st.tropo, 0, 1).to(st.jpress.dtype)
    acc = None
    for dt in range(2):
        je = torch.where(st.tropo, st.jeta[fl_low][dt], st.jeta[fl_upp][dt])
        fe = torch.where(st.tropo, st.feta[fl_low][dt], st.feta[fl_upp][dt])
        wt = (1.0 - st.ftemp) if dt == 0 else st.ftemp
        if with_cmix:
            wt = torch.where(st.tropo, st.col_mix[fl_low][dt],
                             st.col_mix[fl_upp][dt]) * wt
        base = ((st.jtemp + dt) * neta + je) * npp + p0
        for de in range(2):
            we = (1.0 - fe) if de == 0 else fe
            for dp_ in range(2):
                wp = (1.0 - st.fpress) if dp_ == 0 else st.fpress
                term = (wt * we * wp)[..., None] \
                    * _gather_rows(flat, base + de * npp + dp_)
                acc = term if acc is None else acc + term
    return acc


def tau_major(data, st: InterpState, dtype):
    """Major-species optical depth, all bands at once.

    kmajor [ntemp, neta, npress+1, ngpt]; press index is jpress for the
    lower atmosphere and jpress+1 above the tropopause (the RRTMGP
    press-axis doubling at the troposphere split).
    """
    kmajor = data["kmajor"]
    ngpt = kmajor.shape[-1]
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)  # [2, ngpt]
    tau = torch.zeros((st.ncol, st.nlay, ngpt), dtype=dtype,
                      device=kmajor.device)
    for (fl_low, fl_upp), gs in _flavor_groups(gpt_flavor, (0, 1)).items():
        tau[..., on_device(gs, tau.device)] = _interp3(
            st, kmajor.to(dtype), gs, fl_low, fl_upp, True)
    return tau


def tau_minor(data, st: InterpState, play_pa, tlay, which, dtype):
    """Minor-contributor optical depths (gas_optical_depths_minor)."""
    md = data[which]
    if md is None or md["kminor"].numel() == 0:
        return 0.0
    kminor = md["kminor"].to(dtype)        # [ntemp, neta, nk_total]
    ntemp, neta, _ = kminor.shape
    gpt_lims = np.asarray(md["gpt_limits"], np.int64)
    gas_idx = np.asarray(md["gas_idx"], np.int64)
    swd = np.asarray(md["scales_with_density"], bool)
    sgas = np.asarray(md["scaling_gas"], np.int64)
    sbc = np.asarray(md["scale_by_complement"], bool)
    ngpt = int(data["kmajor"].shape[-1])
    in_lower = which == "minor_lower"
    mask = st.tropo if in_lower else ~st.tropo
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)

    tau = torch.zeros((st.ncol, st.nlay, ngpt), dtype=dtype,
                      device=kminor.device)
    col_dry = st.col_gas[0]
    h2o = st.col_gas[int(data["h2o_idx"])]
    k0 = 0
    for m in range(gpt_lims.shape[0]):
        g1, g2 = int(gpt_lims[m, 0]) - 1, int(gpt_lims[m, 1])
        nk = g2 - g1
        kflat = kminor[:, :, k0:k0 + nk].reshape(ntemp * neta, nk)
        k0 += nk
        scaling = st.col_gas[int(gas_idx[m])]
        if swd[m]:
            scaling = scaling * (PA2HPA * play_pa / tlay)
            if int(sgas[m]) != 0:
                dry_fact = 1.0 / (1.0 + h2o / torch.clamp(col_dry,
                                                          min=1e-60))
                frac = st.col_gas[int(sgas[m])] \
                    / torch.clamp(col_dry, min=1e-60) * dry_fact
                scaling = scaling * ((1.0 - frac) if sbc[m] else frac)
        # flavor is resolved PER G-POINT (mo_gas_optics_rrtmgp
        # gpoint_flavor): the contributor's g-points grouped by flavor;
        # standard coefficient sets keep one flavor per minor range
        fls = gpt_flavor[0 if in_lower else 1, g1:g2] - 1   # [nk]
        acc = torch.empty(st.ftemp.shape + (nk,), dtype=dtype,
                          device=kminor.device)
        for fl in np.unique(fls):
            sel = on_device(np.nonzero(fls == fl)[0], kminor.device)
            kf = kflat[:, sel]
            acc_fl = None
            for dt in range(2):
                w0, w1 = st.fminor(int(fl), dt)
                base = (st.jtemp + dt) * neta + st.jeta[int(fl)][dt]
                term = w0[..., None] * _gather_rows(kf, base) \
                    + w1[..., None] * _gather_rows(kf, base + 1)
                acc_fl = term if acc_fl is None else acc_fl + term
            acc[..., sel] = acc_fl
        contrib = (scaling * mask.to(dtype))[..., None] * acc
        tau[..., g1:g2] += contrib
    return tau


def _planck_interp(totplnk, tref, t):
    """Linear interpolation of the band-integrated Planck table at t."""
    t0, dtp = float(tref[0]), float(tref[1] - tref[0])
    idx = torch.clamp(torch.floor((t - t0) / dtp).to(torch.int64), 0,
                      tref.size - 2)
    f = (t - (t0 + idx * dtp)) / dtp
    lo = totplnk[idx]
    return lo + f[..., None] * (totplnk[idx + 1] - lo)


def planck_source(data, st: InterpState, tlay, tlev, tsfc, dtype):
    """Planck fractions + band-integrated Planck sources (LW).

    Returns (pfrac [ncol, nlay, ngpt], planklay [ncol, nlay, nbnd],
    planklev [ncol, nlay+1, nbnd], plankbnd [ncol, nbnd],
    dplankbnd_dts [ncol, nbnd]).
    """
    pf = data["planck_frac"].to(dtype)
    ngpt = pf.shape[-1]
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)
    pfrac = torch.zeros((st.ncol, st.nlay, ngpt), dtype=dtype,
                        device=pf.device)
    for (fl_low, fl_upp), gs in _flavor_groups(gpt_flavor, (0, 1)).items():
        pfrac[..., on_device(gs, pf.device)] = _interp3(
            st, pf, gs, fl_low, fl_upp, False)

    totplnk = data["totplnk"].to(dtype)
    tref = np.asarray(data["temp_ref_planck"], np.float64)
    planklay = _planck_interp(totplnk, tref, tlay)
    planklev = _planck_interp(totplnk, tref, tlev)
    plankbnd = _planck_interp(totplnk, tref, tsfc)
    # analytic slope of the active piecewise-linear segment (a one-sided
    # finite difference can straddle two segments near a table node)
    t0, dtp = float(tref[0]), float(tref[1] - tref[0])
    idx_s = torch.clamp(torch.floor((tsfc - t0) / dtp).to(torch.int64), 0,
                        tref.size - 2)
    dplankbnd_dts = (totplnk[idx_s + 1] - totplnk[idx_s]) / dtp
    return pfrac, planklay, planklev, plankbnd, dplankbnd_dts


def tau_rayleigh(data, st: InterpState, dtype):
    """Rayleigh optical depth (SW): krayl [2, ntemp, neta, ngpt]
    interpolated in (temp, eta), scaled by (col_dry + col_h2o)."""
    krayl = data["rayl"].to(dtype)
    _, ntemp, neta, ngpt = krayl.shape
    gpt_flavor = np.asarray(data["gpoint_flavor"], np.int64)
    taur = torch.zeros((st.ncol, st.nlay, ngpt), dtype=dtype,
                       device=krayl.device)
    scale = st.col_gas[0] + st.col_gas[int(data["h2o_idx"])]
    for itropo in range(2):
        mask = st.tropo if itropo == 0 else ~st.tropo
        kflat = krayl[itropo].reshape(ntemp * neta, ngpt)
        for (fl,), gs in _flavor_groups(gpt_flavor, (itropo,)).items():
            gsel = on_device(gs, krayl.device)
            kf = kflat[:, gsel]
            acc = None
            for dt in range(2):
                w0, w1 = st.fminor(fl, dt)
                base = (st.jtemp + dt) * neta + st.jeta[fl][dt]
                term = w0[..., None] * _gather_rows(kf, base) \
                    + w1[..., None] * _gather_rows(kf, base + 1)
                acc = term if acc is None else acc + term
            taur[..., gsel] += (mask.to(dtype) * scale)[..., None] * acc
    return taur


# ---------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------

def _state(data, play_pa, tlay, plev_pa, vmrs):
    """The column amounts (gas 0 dry air, then data["gas_names"]' order)
    and the interpolation state."""
    names = [str(s) for s in data["gas_names"]]
    h2o = vmrs.get("h2o", torch.zeros_like(tlay))
    _, col_dry = column_gas(plev_pa, torch.ones_like(tlay), h2o)
    col_gas = [col_dry] + [col_dry * vmrs.get(nm, torch.zeros_like(tlay))
                           for nm in names]
    return col_gas, InterpState(data, play_pa, tlay, col_gas)


def _tau_gas(data, st, play_pa, tlay):
    dtype = tlay.dtype
    taug = tau_major(data, st, dtype)
    taug = taug + tau_minor(data, st, play_pa, tlay, "minor_lower", dtype)
    return taug + tau_minor(data, st, play_pa, tlay, "minor_upper", dtype)


def gas_optics_lw(data, play_pa, tlay, plev_pa, tlev, tsfc, vmrs):
    """Generic LW gas optics from a native coefficient set.

    vmrs: dict gas-name -> [ncol, nlay] vmr; data["gas_names"] orders
    the gas axis (gas 0 is dry air).
    Returns (taug [ncol, nlay, ngpt], sources dict).
    """
    col_gas, st = _state(data, play_pa, tlay, plev_pa, vmrs)
    taug = _tau_gas(data, st, play_pa, tlay)
    pfrac, planklay, planklev, plankbnd, dpl = planck_source(
        data, st, tlay, tlev, tsfc, tlay.dtype)
    # precipitable water [cm] for the rtrnmc diffusivity-angle fit
    pwvcm = torch.sum(col_gas[int(data["h2o_idx"])], dim=-1) \
        * (18.015 / 6.02214076e23)
    sources = dict(pfracs=pfrac, planklay=planklay, planklev=planklev,
                   plankbnd=plankbnd, dplankbnd_dts=dpl, pwvcm=pwvcm)
    return taug, sources


def gas_optics_sw(data, play_pa, tlay, plev_pa, vmrs):
    """Generic SW gas optics: (taug, taur, toa_src [ncol, ngpt])."""
    _, st = _state(data, play_pa, tlay, plev_pa, vmrs)
    taug = _tau_gas(data, st, play_pa, tlay)
    taur = tau_rayleigh(data, st, tlay.dtype)
    src = data["solar_src"].to(tlay.dtype).expand(st.ncol, taug.shape[-1])
    return taug, taur, src
