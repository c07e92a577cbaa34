"""Radiation driver: intermittent refresh + cheap per-heartbeat updates.

Port of geosradiation_gridcomp_tpu/driver/radiation.py, its RRTMG,
Chou-Suarez and RRTMGP branches: SOLAR `solar_refresh` (with the optional
aerosol and the no-aerosol second pass) and `solar_update`; IRRAD
`irrad_refresh` (likewise) and `irrad_update`; `heating_rates` and
`surface_lw_linearization`. The composite heating-rate synthesis matches
GEOS_RadiationGridComp.F90:798-819.

AtmosInputs carries the SOLAR/IRRAD import fields as column batches of
torch tensors, TOA-first.
"""

import functools
from typing import NamedTuple

import torch

from ..config import RadiationConfig, Scheme
from ..constants import CP, GRAV

from ..models.chou_lw import chou_lw
from ..models.chou_sw import chou_sw
from ..models.rrtmg.lw import (RRTMGLW, level_temperatures, mid_heights,
                               rrtmg_lw)
from ..models.rrtmg.sw import RRTMGSW, rrtmg_sw
from ..models.rrtmgp.scheme import rrtmgp_lw, rrtmgp_sw
from .astronomy import float32_scalar, earth_sun_factor
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


@functools.lru_cache(maxsize=None)
def reference_modules(device):
    """RRTMG's SW and LW table modules on device, built once: the
    counterpart of jit baking the tables into the executable. Every
    refresh that is given no module takes these, so that the scheme
    entries see one static module per device."""
    return (RRTMGSW.from_reference_tables(device),
            RRTMGLW.from_reference_tables(device))


def _undef_like(x):
    return torch.full_like(x, UNDEF)


def _undef_cldfrc(ref):
    """UNDEF-filled [ncol, 4] cloud-fraction diagnostic (the scheme gives
    no McICA subcolumn counts, or the output is pruned by config)."""
    return torch.full((ref.shape[0], 4), UNDEF, dtype=ref.dtype,
                      device=ref.device)


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
                  nlit=None, ncld=None, sw: RRTMGSW = None) -> SolarState:
    """Full SW RT; stores NORMALIZED internals (fractions of TOA insolation
    at the refresh-time zenith angle). cosz: [ncol] mean cosine over the
    refresh interval (lit part).

    With aerosols present and "no_aerosol" in config.outputs, a second
    aerosol-free pass fills the no-aerosol internals; without aerosols
    they alias the all-sky ones, as in the reference. sw: the RRTMGSW
    holding the tables (reference_modules of the inputs' device when None
    and the scheme is RRTMG or RRTMGP, whose facade and cloud optics use
    them).
    """
    if sw is None and config.sw_scheme in (Scheme.RRTMG, Scheme.RRTMGP):
        sw = reference_modules(inp.t.device)[0]
    st = _solar_refresh_pass(inp, cosz, doy, config, ict, icb, taua, ssaa,
                             asya, nlit, ncld, sw)
    if taua is None:
        return st._replace(flxnan=st.flxn, flcnan=st.flcn,
                           flxunan=st.flxun)
    if config.wants("no_aerosol"):
        na = _solar_refresh_pass(inp, cosz, doy, config, ict, icb, None,
                                 None, None, nlit, ncld, sw)
        return st._replace(flxnan=na.flxn, flcnan=na.flcn,
                           flxunan=na.flxun)
    return st


def _solar_refresh_pass(inp, cosz, doy, config, ict, icb, taua, ssaa, asya,
                        nlit, ncld, sw) -> SolarState:
    if config.sw_scheme == Scheme.CHOU:
        cwc, reff = _cwc_reff(inp)
        out = chou_sw(cosz, inp.ple, inp.t, inp.qv, inp.o3, inp.co2,
                      cwc, inp.fcld, reff,
                      taua=taua, ssaa=ssaa, asya=asya,
                      rsuvbm=inp.albvr, rsuvdf=inp.albvf,
                      rsirbm=inp.albnr, rsirdf=inp.albnf,
                      ict=ict, icb=icb)
        undef = _undef_like(out["flx"])
        return SolarState(
            flxn=out["flx"], flcn=out["flc"],
            flxun=out["flxu"], flcun=out["flcu"],
            fdir_uv_n=out["fdiruv"], fdif_uv_n=out["fdifuv"],
            fdir_par_n=out["fdirpar"], fdif_par_n=out["fdifpar"],
            fdir_nir_n=out["fdirir"], fdif_nir_n=out["fdifir"],
            flx_sfc_band_n=out["flx_sfc_band"],
            drband_n=out["drband"], dfband_n=out["dfband"],
            cldfrc=_undef_cldfrc(cosz),
            flxnan=undef, flcnan=undef, flxunan=undef)
    play, h2ovmr, o3vmr = _common_derived(inp)
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)
    # normalize by refresh-time TOA insolation
    s0 = config.effective_scon() * torch.clamp(cosz, min=1e-6)
    inv = torch.where(cosz > 0.0, 1.0 / s0, torch.zeros_like(s0))

    def nv(x):
        return x * inv.reshape((-1,) + (1,) * (x.ndim - 1))
    if config.sw_scheme == Scheme.RRTMGP:
        out = rrtmgp_sw(sw, inp.ple, play, inp.t, cosz,
                        inp.albvr, inp.albvf, inp.albnr, inp.albnf,
                        h2ovmr, o3vmr, inp.co2, inp.ch4,
                        torch.full_like(inp.co2, 0.2095),
                        inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                        zm, inp.lats, doy,
                        taua=taua, ssaa=ssaa, asya=asya,
                        iceflag=config.iceflag_sw,
                        liqflag=config.liqflag_sw,
                        inhm=config.condensate_inhomogeneity,
                        kdist_path=config.rrtmgp_kdist_sw)
        # the RRTMGP path gives broadband and direct fluxes only: the
        # band diagnostics read the GEOS missing-data marker (MAPL_UNDEF),
        # "not available" rather than silent zeros; PAR direct/diffuse
        # carry the surface direct and diffuse, UV and NIR read zero
        zb = torch.full(cosz.shape + (14,), UNDEF, dtype=out["bbfd"].dtype,
                        device=cosz.device)
        zc = torch.zeros_like(cosz)
        sfc_dir = nv(out["bbfddir"][:, -1])
        undef = _undef_like(out["bbfd"])
        return SolarState(
            flxn=nv(out["bbfd"] - out["bbfu"]),
            flcn=nv(out["bbcd"] - out["bbcu"]),
            flxun=nv(out["bbfu"]), flcun=nv(out["bbcu"]),
            fdir_uv_n=zc, fdif_uv_n=zc,
            fdir_par_n=sfc_dir, fdif_par_n=nv(out["bbfd"][:, -1]) - sfc_dir,
            fdir_nir_n=zc, fdif_nir_n=zc,
            flx_sfc_band_n=zb, drband_n=zb, dfband_n=zb,
            cldfrc=_undef_cldfrc(cosz),
            flxnan=undef, flcnan=undef, flxunan=undef)
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
                   ncld=ncld)
    if config.wants("clear_counts"):
        cldfrc = 1.0 - out["clear_counts"].to(out["bbfd"].dtype) / 112.0
    else:
        cldfrc = _undef_cldfrc(cosz)
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
    doy_now = float32_scalar(doy_now, cosz_now)
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
                  lw: RRTMGLW = None) -> IrradState:
    """Full LW RT; stores fluxes + dF/dTs Jacobian at refresh time.

    taua/ssaa/asya: LW aerosol optics; Chou-Suarez takes all three
    [ncol, nlay, 10], RRTMG-LW (absorption-only) taua alone
    [ncol, nlay, 16]; RRTMGP takes none. lw: the RRTMGLW holding the
    tables (reference_modules of the inputs' device when None).
    """
    if config.lw_scheme == Scheme.CHOU:
        return _chou_irrad_refresh(inp, config, ict, icb, taua, ssaa, asya)
    if lw is None:
        lw = reference_modules(inp.t.device)[1]
    if config.lw_scheme == Scheme.RRTMGP:
        return _rrtmgp_irrad_refresh(inp, doy, config, lw)
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
                        inhm=config.condensate_inhomogeneity)

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


def _rrtmgp_irrad_refresh(inp, doy, config, lw):
    play, h2ovmr, o3vmr = _common_derived(inp)
    ncol = inp.t.shape[0]
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = _incloud_paths(inp)
    out = rrtmgp_lw(lw, inp.ple, play, inp.t, inp.tsinst,
                    inp.emis[:, None].expand(ncol, 16),
                    h2ovmr, o3vmr, inp.co2, inp.ch4, inp.n2o,
                    torch.full_like(inp.co2, 0.2095),
                    inp.cfc11, inp.cfc12, inp.hcfc22,
                    inp.fcld, ciwp, clwp, inp.ri, inp.rl,
                    zm, inp.lats, doy,
                    iceflag=config.iceflag_lw, liqflag=config.liqflag_lw,
                    inhm=config.condensate_inhomogeneity,
                    dudts=config.ts_derivs,
                    kdist_path=config.rrtmgp_kdist_lw)
    net = out["flux_dn"] - out["flux_up"]
    clr = out["flux_dn_clr"] - out["flux_up_clr"]
    if config.ts_derivs:
        dfdts, dfdtsc = -out["duflx_dts"], -out["duflxc_dts"]
    else:
        dfdts = dfdtsc = torch.zeros_like(net)
    sfcem = -(out["flux_up"][:, -1]
              - out["flux_dn"][:, -1] * (1.0 - inp.emis))
    zb = torch.zeros((ncol, 16), dtype=net.dtype, device=net.device)
    wants_olrb = config.wants("olrb")
    return IrradState(
        flx=net, flc=clr, flxu=out["flux_up"], flxd=out["flux_dn"],
        dfdts=dfdts, sfcem=sfcem, ts=inp.tsinst,
        olrb=out["olrb"] if wants_olrb else zb,
        dolrb_dts=(out["dolrb_dts"] if config.ts_derivs and wants_olrb
                   else zb),
        # the RRTMGP LW path takes no aerosol optics: the no-aerosol
        # fluxes alias the all-sky ones, DFDTSCNA the clear-sky
        # derivative (GEOS_IrradGridComp.F90:3127,3556)
        flxa=net, fla=clr, dfdtsna=dfdts, dfdtscna=dfdtsc)


def _chou_irrad_refresh(inp, config, ict, icb, taua, ssaa, asya):
    cwc, reff = _cwc_reff(inp)
    ncol = inp.t.shape[0]
    emis10 = inp.emis[:, None].expand(ncol, 10)
    out = chou_lw(inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
                  emis10, inp.co2, inp.n2o, inp.ch4,
                  inp.cfc11, inp.cfc12, inp.hcfc22,
                  cwc, inp.fcld, reff, taua=taua, ssaa=ssaa, asya=asya,
                  ict=ict, icb=icb, trace=config.trace_gases,
                  with_aerosol=taua is not None)
    # Chou sign: up negative, down positive; net downward = flxd + flxu
    zb = torch.zeros((ncol, 16), dtype=out["flxd"].dtype,
                     device=out["flxd"].device)
    # the Chou solve emits the no-aerosol variants from the same sweep
    return IrradState(
        flx=out["flxd"] + out["flxu"], flc=out["flcd"] + out["flcu"],
        flxu=-out["flxu"], flxd=out["flxd"],
        dfdts=out["dfdts"], sfcem=out["sfcem"], ts=inp.tsinst,
        # band OLR is an RRTMG-only diagnostic in the reference
        # (GEOS_IrradGridComp.F90:1257)
        olrb=zb, dolrb_dts=zb,
        flxa=out["flxad"] + out["flxau"], fla=out["flad"] + out["flau"],
        # GEOS_IrradGridComp.F90:2105-2109: "Chou-Suarez does not provide
        # these derivatives": DFDTSNA=DFDTS, DFDTSCNA=DFDTSC(=0)
        dfdtsna=out["dfdts"], dfdtscna=torch.zeros_like(out["dfdts"]))


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
