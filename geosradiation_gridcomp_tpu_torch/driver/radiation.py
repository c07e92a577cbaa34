"""Radiation driver: intermittent refresh + cheap per-heartbeat updates.

Port of geosradiation_gridcomp_tpu/driver/radiation.py, RRTMG branches:
SOLAR `solar_refresh` (with the optional aerosol and the no-aerosol
second pass) and `solar_update`; IRRAD `irrad_refresh` (likewise) and
`irrad_update`; `heating_rates` and `surface_lw_linearization`. The
composite heating-rate synthesis matches GEOS_RadiationGridComp.F90:
798-819.

AtmosInputs carries the SOLAR/IRRAD import fields as column batches of
torch tensors, TOA-first.
"""

from typing import NamedTuple

import torch

from ..config import RadiationConfig, Scheme
from ..constants import CP, GRAV

from ..models.rrtmg.lw import (RRTMGLW, level_temperatures, mid_heights,
                               rrtmg_lw)
from ..models.rrtmg.sw import RRTMGSW, rrtmg_sw
from .astronomy import earth_sun_factor
from .diagnostics import UNDEF, band_brightness_temperature
from .state import IrradState, SolarState

_AMD, _AMW, _AMO3 = 28.9660, 18.0160, 47.9982


class AtmosInputs(NamedTuple):
    """Radiation import state (column batch, TOA-first)."""
    ple: torch.Tensor        # [ncol, nlev+1] edge pressure (Pa)
    t: torch.Tensor          # [ncol, nlev] layer temperature (K)
    qv: torch.Tensor         # [ncol, nlev] specific humidity (kg/kg)
    ql: torch.Tensor         # cloud liquid mass fraction
    qi: torch.Tensor         # cloud ice
    qr: torch.Tensor         # rain
    qs: torch.Tensor         # snow
    rl: torch.Tensor         # effective radii (micron)
    ri: torch.Tensor
    rr: torch.Tensor
    rs: torch.Tensor
    o3: torch.Tensor         # ozone mass mixing ratio (kg/kg)
    fcld: torch.Tensor       # cloud fraction
    ch4: torch.Tensor        # vmr
    n2o: torch.Tensor
    cfc11: torch.Tensor
    cfc12: torch.Tensor
    hcfc22: torch.Tensor
    co2: torch.Tensor        # [ncol, nlev] vmr
    ts: torch.Tensor         # [ncol] skin temperature (refresh average)
    tsinst: torch.Tensor     # [ncol] instantaneous skin temperature
    t2m: torch.Tensor        # [ncol] surface air temperature
    emis: torch.Tensor       # [ncol] broadband surface emissivity
    albvr: torch.Tensor      # [ncol] visible direct albedo
    albvf: torch.Tensor      # visible diffuse
    albnr: torch.Tensor      # NIR direct
    albnf: torch.Tensor      # NIR diffuse
    lats: torch.Tensor       # [ncol] radians
    lons: torch.Tensor       # [ncol] radians


def _undef_like(x):
    return torch.full_like(x, UNDEF)


def _cwc_reff(inp):
    cwc = torch.stack([inp.qi, inp.ql, inp.qr, inp.qs], dim=-1)
    reff = torch.stack([inp.ri, inp.rl, inp.rr, inp.rs], dim=-1)
    return cwc, reff


def _common_derived(inp):
    play = 0.5 * (inp.ple[..., 1:] + inp.ple[..., :-1]) * 0.01
    h2ovmr = inp.qv * (_AMD / _AMW) / (1.0 - inp.qv)
    o3vmr = inp.o3 * (_AMD / _AMO3)
    return play, h2ovmr, o3vmr


def _incloud_paths(inp):
    """In-cloud water paths (g/m^2) from grid-mean mixing ratios."""
    dp = inp.ple[..., 1:] - inp.ple[..., :-1]
    icq = torch.where(inp.fcld > 0.0,
                      1.0 / torch.clamp(inp.fcld, min=1e-6),
                      torch.zeros_like(inp.fcld))
    ciwp = inp.qi * dp * 1e3 / GRAV * icq
    clwp = inp.ql * dp * 1e3 / GRAV * icq
    return ciwp, clwp


# --------------------------------------------------------------------------
# SOLAR
# --------------------------------------------------------------------------

def solar_refresh(inp: AtmosInputs, cosz, doy, config: RadiationConfig,
                  ict, icb, taua=None, ssaa=None, asya=None,
                  nlit=None, ncld=None, sw: RRTMGSW = None,
                  plain=False) -> SolarState:
    """Full SW RT; stores NORMALIZED internals (fractions of TOA insolation
    at the refresh-time zenith angle). cosz: [ncol] mean cosine over the
    refresh interval (lit part).

    With aerosols present and "no_aerosol" in config.outputs, a second
    aerosol-free pass fills the no-aerosol internals; without aerosols
    they alias the all-sky ones, as in the reference. sw: the RRTMGSW
    holding the tables (built on the inputs' device when None).
    plain=True runs the kernels' plain PyTorch twins (see rrtmg_sw).
    """
    if sw is None:
        sw = RRTMGSW.from_reference_tables(inp.t.device)
    st = _solar_refresh_pass(inp, cosz, doy, config, ict, icb, taua, ssaa,
                             asya, nlit, ncld, sw, plain)
    if taua is None:
        return st._replace(flxnan=st.flxn, flcnan=st.flcn,
                           flxunan=st.flxun)
    if config.wants("no_aerosol"):
        na = _solar_refresh_pass(inp, cosz, doy, config, ict, icb, None,
                                 None, None, nlit, ncld, sw, plain)
        return st._replace(flxnan=na.flxn, flcnan=na.flcn,
                           flxunan=na.flxun)
    return st


def _solar_refresh_pass(inp, cosz, doy, config, ict, icb, taua, ssaa, asya,
                        nlit, ncld, sw, plain) -> SolarState:
    if config.sw_scheme == Scheme.CHOU:
        raise NotImplementedError(
            "Chou-Suarez SW is not ported yet (ROADMAP Queue 1: Chou-Suarez)")
    if config.sw_scheme == Scheme.RRTMGP:
        raise NotImplementedError(
            "RRTMGP SW is not ported yet (ROADMAP Queue 1: RRTMGP)")
    play, h2ovmr, o3vmr = _common_derived(inp)
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)
    out = rrtmg_sw(sw, inp.ple, play, inp.t, cosz,
                   inp.albvr, inp.albvf, inp.albnr, inp.albnf,
                   h2ovmr, o3vmr, inp.co2, inp.ch4,
                   torch.full_like(inp.co2, 0.2095),
                   inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                   zm, inp.lats, doy,
                   taua=taua, ssaa=ssaa, asya=asya,
                   scon=config.solar_constant,
                   isolvar=config.isolvar,
                   solcycfrac=(config.solcycfrac
                               if config.isolvar == 1 else None),
                   indsolvar=config.indsolvar,
                   iceflag=config.iceflag_sw, liqflag=config.liqflag_sw,
                   cloud_mh=ict, cloud_lm=icb,
                   inhm=config.condensate_inhomogeneity, nlit=nlit,
                   ncld=ncld, plain=plain)
    # normalize by refresh-time TOA insolation
    s0 = config.effective_scon() * torch.clamp(cosz, min=1e-6)
    inv = torch.where(cosz > 0.0, 1.0 / s0, torch.zeros_like(s0))

    def nv(x):
        return x * inv.reshape((-1,) + (1,) * (x.ndim - 1))
    if config.wants("clear_counts"):
        cldfrc = 1.0 - out["clear_counts"].to(out["bbfd"].dtype) / 112.0
    else:
        cldfrc = torch.full((cosz.shape[0], 4), UNDEF, dtype=cosz.dtype,
                            device=cosz.device)
    undef = _undef_like(out["bbfd"])
    return SolarState(
        flxn=nv(out["bbfd"] - out["bbfu"]),
        flcn=nv(out["bbcd"] - out["bbcu"]),
        flxun=nv(out["bbfu"]), flcun=nv(out["bbcu"]),
        fdir_uv_n=nv(out["uvrr"]), fdif_uv_n=nv(out["uvrf"] - out["uvrr"]),
        fdir_par_n=nv(out["parr"]), fdif_par_n=nv(out["parf"] - out["parr"]),
        fdir_nir_n=nv(out["nirr"]), fdif_nir_n=nv(out["nirf"] - out["nirr"]),
        flx_sfc_band_n=nv(out["fndsbnd"]),
        drband_n=nv(out["drband"]), dfband_n=nv(out["dfband"]),
        cldfrc=cldfrc, flxnan=undef, flcnan=undef, flxunan=undef)


def solar_update(state: SolarState, cosz_now, doy_now,
                 config: RadiationConfig):
    """Cheap per-heartbeat export: rescale the normalized internals by the
    CURRENT TOA insolation (UPDATE_EXPORT, GEOS_SolarGridComp.F90:6676+).

    Returns dict of W/m^2 exports.
    """
    doy_now = torch.as_tensor(doy_now, dtype=torch.float32,
                              device=cosz_now.device)
    sln = (config.effective_scon() * earth_sun_factor(doy_now)
           * torch.clamp(cosz_now, min=0.0))

    def scv(x):
        return x * sln.reshape((-1,) + (1,) * (x.ndim - 1))

    def sc(x):
        # the missing-data marker survives the rescale
        return torch.where(x >= UNDEF, x, scv(x))
    out = dict(
        fsw=scv(state.flxn), fsc=scv(state.flcn),
        fswu=scv(state.flxun), fscu=scv(state.flcun),
        drpar=sc(state.fdir_par_n), dfpar=sc(state.fdif_par_n),
        druvr=sc(state.fdir_uv_n), dfuvr=sc(state.fdif_uv_n),
        drnir=sc(state.fdir_nir_n), dfnir=sc(state.fdif_nir_n))
    if config.wants("band_sfc"):
        out.update(flx_sfc_band=sc(state.flx_sfc_band_n),
                   drband=sc(state.drband_n), dfband=sc(state.dfband_n))
    if config.wants("no_aerosol"):
        out.update(fswna=sc(state.flxnan), fscna=sc(state.flcnan),
                   fswuna=sc(state.flxunan))
    return out


# --------------------------------------------------------------------------
# IRRAD
# --------------------------------------------------------------------------

def irrad_refresh(inp: AtmosInputs, doy, config: RadiationConfig,
                  ict, icb, taua=None, ssaa=None, asya=None,
                  lw: RRTMGLW = None, plain=False) -> IrradState:
    """Full LW RT; stores fluxes + dF/dTs Jacobian at refresh time.

    lw: the RRTMGLW holding the tables (built from the reference tables
    on the inputs' device when None). ssaa/asya are accepted for the
    reference's signature; RRTMG-LW is absorption-only. plain=True runs
    the kernels' plain PyTorch twins on any device (see rrtmg_lw).
    """
    if config.lw_scheme == Scheme.CHOU:
        raise NotImplementedError(
            "Chou-Suarez LW is not ported yet (ROADMAP Queue 1: Chou-Suarez)")
    if config.lw_scheme == Scheme.RRTMGP:
        raise NotImplementedError(
            "RRTMGP LW is not ported yet (ROADMAP Queue 1: RRTMGP)")
    if lw is None:
        lw = RRTMGLW.from_reference_tables(inp.t.device)
    play, h2ovmr, o3vmr = _common_derived(inp)
    ncol = inp.t.shape[0]
    emis16 = inp.emis[:, None].expand(ncol, 16)
    tlev = level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)

    def solve(taua_pass):
        return rrtmg_lw(lw, inp.ple, play, inp.t, tlev, inp.tsinst, emis16,
                        h2ovmr, o3vmr, inp.co2, inp.ch4, inp.n2o,
                        torch.full_like(inp.co2, 0.2095),
                        torch.zeros_like(inp.co2),
                        inp.cfc11, inp.cfc12, inp.hcfc22,
                        torch.zeros_like(inp.co2),
                        inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                        zm, inp.lats, doy, taua=taua_pass,
                        iceflag=config.iceflag_lw,
                        liqflag=config.liqflag_lw,
                        dudts=config.ts_derivs,
                        cloud_mh=ict, cloud_lm=icb,
                        inhm=config.condensate_inhomogeneity,
                        plain=plain)

    def derivs(o):
        if not config.ts_derivs:
            z = torch.zeros_like(o["uflx"])
            return z, z
        return -o["duflx_dts"], -o["duflxc_dts"]

    out = solve(taua)
    net = out["dflx"] - out["uflx"]
    dfdts, dfdtsc = derivs(out)
    sfcem = -(out["uflx"][:, -1] - out["dflx"][:, -1] * (1.0 - inp.emis))
    zb = torch.zeros((ncol, 16), dtype=net.dtype, device=net.device)
    wants_olrb = config.wants("olrb")
    if taua is None:
        # aerosol-free run: the no-aerosol quadruple is the quadruple
        flxa, fla = net, out["dflxc"] - out["uflxc"]
        dfdtsna, dfdtscna = dfdts, dfdtsc
    elif config.wants("no_aerosol"):
        # second aerosol-free solve
        na = solve(None)
        flxa = na["dflx"] - na["uflx"]
        fla = na["dflxc"] - na["uflxc"]
        dfdtsna, dfdtscna = derivs(na)
    else:
        flxa = fla = dfdtsna = dfdtscna = _undef_like(net)
    return IrradState(
        flx=net, flc=out["dflxc"] - out["uflxc"],
        flxu=out["uflx"], flxd=out["dflx"],
        dfdts=dfdts, sfcem=sfcem, ts=inp.tsinst,
        olrb=out["olrb"] if wants_olrb else zb,
        dolrb_dts=(out.get("dolrb_dts", zb)
                   if config.ts_derivs and wants_olrb else zb),
        flxa=flxa, fla=fla, dfdtsna=dfdtsna, dfdtscna=dfdtscna)


def irrad_update(state: IrradState, tsinst, config: RadiationConfig = None):
    """Per-heartbeat Ts-linearized flux advance (Update_Flx,
    GEOS_IrradGridComp.F90:3684-4129): F = F_int + dF/dTs * (Ts - Ts_int).

    Returns dict of W/m^2 exports (net downward convention); band OLR and
    brightness temperatures only when the config's outputs request them.
    """
    delt = (tsinst - state.ts)[:, None]
    flx = state.flx + state.dfdts * delt
    out = dict(flw=flx, flc=state.flc, olr=-(flx[:, 0]), flns=-(flx[:, -1]),
               sfcem=state.sfcem + state.dfdts[:, -1] * delt[:, 0],
               lws=-state.sfcem - state.dfdts[:, -1] * delt[:, 0])
    if config is None or config.wants("olrb"):
        out["olrb"] = olrb = state.olrb + state.dolrb_dts * delt
        if config is None or config.wants("tbrb"):
            out["tbrb"] = band_brightness_temperature(olrb)
    if config is not None and config.wants("no_aerosol"):
        # UNDEF marker preserved when the internals were pruned
        def adv(f, d):
            return torch.where(f >= UNDEF, f, f + d * delt)
        out.update(flwa=adv(state.flxa, state.dfdtsna),
                   flca_na=adv(state.fla, state.dfdtscna))
    return out


def heating_rates(fsw_net, flw_net, ple):
    """DTDT [K/s] from SW+LW net downward flux profiles at levels."""
    dp = ple[..., 1:] - ple[..., :-1]
    dflux = (fsw_net[..., :-1] - fsw_net[..., 1:]) \
        + (flw_net[..., :-1] - flw_net[..., 1:])
    return dflux * GRAV / (CP * dp)


def surface_lw_linearization(state: IrradState):
    """ALW/BLW exports for the surface energy balance:
    LW_sfc(Ts) ~ ALW + BLW * Ts."""
    dsfdts = -state.dfdts[:, -1]
    alw = state.sfcem - dsfdts * state.ts
    return dict(alw=alw, blw=dsfdts)
