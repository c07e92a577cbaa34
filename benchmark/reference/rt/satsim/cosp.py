"""COSP orchestration: the satellite-simulator driver.

Port of geosradiation_gridcomp_tpu/satsim/cosp.py (GEOS_SatsimGridComp.
F90 SIM_DRIVER :2799-5020, cosp.F90 COSP/cosp_iter :41-578 and
cosp_simulator.F90 dispatch): in-cloud condensate prep, Chou-optics
0.67um optical depths and 10.5um emissivities (getvistau/getirtau band
4, GEOS_SatsimGridComp.F90:3425-3452), SCOPS subcolumns + precip
occurrence, gridbox-mean -> subcolumn hydrometeor distribution with
sampled-fraction normalization (cosp.F90:451-520), then the ISCCP,
MISR, MODIS, CALIPSO and CloudSat simulators and their statistics.

One call covers every point with one key (scops draws (nlev, npoints,
nsubcol) from it); only the radar's DSD planes are blocked, inside
quickbeam_simulator. Everything runs on the device of the inputs.

Only the body, `cosp_simulator_eager`, is kept here: the benchmark runs
it eagerly. It reads no device value and copies nothing from host
memory: the simulators' tables and bin edges go to the device once
(tables.on_device), and the radar's classes are a static tuple.

Hydrometeor class order (cosp_constants.F90:116): LSL, LSI, LSR, LSS,
CVL, CVI, CVR, CVS, LSG. GEOS feeds zero convective species
(GEOS_SatsimGridComp.F90:3689-3692), so the radar integrates the five
large-scale classes (PRESENT) and leaves the convective ones out: an
absent class adds exact zeros.
"""

import dataclasses
from typing import NamedTuple

import torch

from ..constants import GRAV
from ..tables import load
from .icarus import isccp_simulator
from .lidar import lidar_simulator, lidar_stats
from .misr import misr_simulator
from .modis import modis_l2_simulator, modis_l3_simulator
from .radar import lidar_only_freq_cloud, quickbeam_simulator, radar_cfad
from .scops import prec_scops, scops
from .stats import change_vertical_grid, csat_vgrid_bounds

# class indices (cosp_constants hclass columns, 0-based)
I_LSCLIQ, I_LSCICE, I_LSRAIN, I_LSSNOW = 0, 1, 2, 3
I_CVCLIQ, I_CVCICE, I_CVRAIN, I_CVSNOW, I_LSGRPL = 4, 5, 6, 7, 8
N_HYDRO = 9
# the classes GEOS fills, the radar's planes in this order
PRESENT = (I_LSCLIQ, I_LSCICE, I_LSRAIN, I_LSSNOW, I_LSGRPL)

ISCCP_EMSFC_LW = 0.99   # 10.5um surface emissivity (COSP default)


class SatsimInputs(NamedTuple):
    """Satsim import state (GEOS_SatsimGridComp.F90:3076-3095), column
    batch, TOA-first."""
    ple: torch.Tensor     # [np, nlev+1] edge pressure (Pa)
    zle: torch.Tensor     # [np, nlev+1] edge heights (m)
    t: torch.Tensor       # [np, nlev] temperature (K)
    qv: torch.Tensor      # [np, nlev] specific humidity (kg/kg)
    fcld: torch.Tensor    # [np, nlev] cloud fraction
    qi: torch.Tensor      # grid-mean ice mixing ratio (kg/kg)
    ql: torch.Tensor      # liquid
    qr: torch.Tensor      # rain
    qs: torch.Tensor      # snow
    qg: torch.Tensor      # graupel
    ri: torch.Tensor      # effective radii (m)
    rl: torch.Tensor
    rr: torch.Tensor
    rs: torch.Tensor
    rg: torch.Tensor
    ts: torch.Tensor      # [np] skin temperature (K)
    mcosz: torch.Tensor   # [np] mean cosine solar zenith
    frland: torch.Tensor  # [np] land fraction


@dataclasses.dataclass(frozen=True)
class SatsimConfig:
    """Static simulator configuration (USE_SATSIM* resources +
    SATSIM_NCOLUMNS, GEOS_SatsimGridComp.F90:3058; COSP cfg flags)."""
    ncolumns: int = 50
    overlap: int = 3                    # ISCCP_OVERLAP (max-random)
    isccp_top_height: int = 1
    isccp_top_height_direction: int = 2
    lidar_ice_type: int = 0
    run_isccp: bool = True
    run_misr: bool = True
    run_modis: bool = True
    run_lidar: bool = True
    run_radar: bool = True
    # stat-grid regridding (CONSTRUCT_COSP_VGRID, cosp_types.F90:554-605;
    # COSP_STATS regrids CFAD inputs when use_vgrid, cosp_stats.F90:78-104)
    use_vgrid: bool = True
    csat_vgrid: bool = True                 # 480 m CloudSat spacing
    nlr: int = 40


def _chou_vis_tau(dp_pa, cwc, reff):
    """Unscaled 0.67um per-hydrometeor optical depths (getvistau.code
    with overlap scaling off, as called by SIM_DRIVER :3425)."""
    t = load("chou_rad_constants")
    aib = float(t["aib_uv"])
    awb = t["awb_uv"]
    arb = float(t["arb_uv"][0])
    zero = torch.zeros((), dtype=dp_pa.dtype, device=dp_pa.device)
    wp = dp_pa * 1.0e3 / GRAV
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = torch.clamp(reff[..., 3], max=112.0)
    t1 = torch.where(re_i > 0.0,
                     wp * cwc[..., 0] * aib / torch.clamp(re_i, min=1e-6),
                     zero)
    t2 = wp * cwc[..., 1] * (awb[0] + awb[1] * re_l)
    t3 = wp * cwc[..., 2] * arb
    t4 = torch.where(re_s > 0.0,
                     wp * cwc[..., 3] * aib / torch.clamp(re_s, min=1e-6),
                     zero)
    return t1, t2, t3, t4


def _chou_ir_tau_band4(dp_pa, cwc, reff):
    """Per-hydrometeor 10.5um (band 4) optical depths (getirtau.code,
    SIM_DRIVER :3430-3452)."""
    t = load("chou_rad_constants")
    aib = t["aib_ir"]   # (3, 10)
    awb = t["awb_ir"]   # (4, 10)
    ib = 3              # band 4, 0-based
    zero = torch.zeros((), dtype=dp_pa.dtype, device=dp_pa.device)
    wp = dp_pa * 1.0e3 / GRAV
    re_i, re_l = reff[..., 0], reff[..., 1]
    re_s = torch.clamp(reff[..., 3], max=112.0)
    t1 = torch.where(re_i > 0.0,
                     wp * cwc[..., 0]
                     * (aib[0, ib] + aib[1, ib]
                        / torch.clamp(re_i, min=1e-6) ** aib[2, ib]), zero)
    t2 = wp * cwc[..., 1] * (awb[0, ib] + (awb[1, ib] + (
        awb[2, ib] + awb[3, ib] * re_l) * re_l) * re_l)
    t3 = 0.00307 * wp * cwc[..., 2]
    t4 = torch.where(re_s > 0.0,
                     wp * cwc[..., 3]
                     * (aib[0, ib] + aib[1, ib]
                        / torch.clamp(re_s, min=1e-6) ** aib[2, ib]), zero)
    return t1, t2, t3, t4


def _distribute(gb_mr, mask, frac):
    """Gridbox-mean -> subcolumn values: place gb value in masked
    subcolumns, normalized by the sampled occupancy fraction
    (cosp.F90:451-520)."""
    zero = torch.zeros((), dtype=gb_mr.dtype, device=gb_mr.device)
    scale = torch.where(frac > 0.0, 1.0 / torch.clamp(frac, min=1e-12), zero)
    return torch.where(mask, (gb_mr * scale)[:, None, :], zero)


def cosp_simulator_eager(key, inp: SatsimInputs,
                         config: SatsimConfig = None):
    """Run the configured satellite simulators on a column batch, the
    body of cosp_simulator.

    key: [2] int64 threefry key pair (ops.threefry.key(seed)).
    Returns a dict of diagnostic groups: 'isccp', 'misr', 'modis',
    'lidar', 'radar' (present per config flags), plus 'frac_out'.
    """
    cfg = config or SatsimConfig()
    ncol = cfg.ncolumns
    dev, fdt = inp.t.device, inp.t.dtype
    zero = torch.zeros((), dtype=fdt, device=dev)
    play = 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    dp = inp.ple[:, 1:] - inp.ple[:, :-1]
    zlo = 0.5 * (inp.zle[:, 1:] + inp.zle[:, :-1])

    # in-cloud condensate (SIM_DRIVER :3377-3390) and radii in um
    icq = torch.where(inp.fcld > 0.01,
                      1.0 / torch.clamp(inp.fcld, min=1e-6), zero)
    has = icq > 0
    cwc = torch.stack([torch.clamp(q * icq, min=1e-12) * has
                       for q in (inp.qi, inp.ql, inp.qr, inp.qs)], dim=-1)
    reff_um = torch.stack([inp.ri, inp.rl, inp.rr, inp.rs], dim=-1) * 1e6

    # 0.67um optical depth and 10.5um emissivity (ice+liquid only,
    # SIM_DRIVER :3437-3452)
    v1, v2, _, _ = _chou_vis_tau(dp, cwc, reff_um)
    dtau_s = v1 + v2
    i1, i2, _, _ = _chou_ir_tau_band4(dp, cwc, reff_um)
    dem_s = -torch.expm1(-(i1 + i2))
    zeros = torch.zeros_like(dtau_s)

    # subcolumn sampling; GEOS has no separate convective cloud
    frac_out = scops(key, inp.fcld, zeros, ncol, overlap=cfg.overlap)
    ls_cld = frac_out == 1

    # precip occurrence from total LS/CV precip mixing ratios
    # (cosp.F90:404-411; mixing-ratio mode, use_precipitation_fluxes=F)
    pf = prec_scops(inp.qr + inp.qs + inp.qg, torch.zeros_like(inp.qr),
                    frac_out)
    ls_prec = (pf == 1) | (pf == 3)

    frac_ls = ls_cld.to(fdt).mean(dim=1)     # sampled LS cloud fraction
    prec_ls = ls_prec.to(fdt).mean(dim=1)

    # subcolumn hydrometeor mixing ratios [kg/kg] (cosp.F90:451-520)
    mr = {
        I_LSCLIQ: _distribute(inp.ql, ls_cld, frac_ls),
        I_LSCICE: _distribute(inp.qi, ls_cld, frac_ls),
        I_LSRAIN: _distribute(inp.qr, ls_prec, prec_ls),
        I_LSSNOW: _distribute(inp.qs, ls_prec, prec_ls),
        I_LSGRPL: _distribute(inp.qg, ls_prec, prec_ls),
    }

    def sub(mask, r):
        """um, a gridbox radius in the cloudy/precip subcolumns"""
        return torch.where(mask, (r * 1e6)[:, None, :], zero)
    re_cld = {I_LSCLIQ: sub(ls_cld, inp.rl), I_LSCICE: sub(ls_cld, inp.ri),
              I_LSRAIN: sub(ls_prec, inp.rr), I_LSSNOW: sub(ls_prec, inp.rs),
              I_LSGRPL: sub(ls_prec, inp.rg)}

    out = {"frac_out": frac_out}
    sunlit = (inp.mcosz > 0.0).to(torch.int32)

    isccp = None
    if cfg.run_isccp or cfg.run_modis:
        isccp = isccp_simulator(
            frac_out, play, inp.ple, inp.qv, inp.t, inp.ts,
            ISCCP_EMSFC_LW, dtau_s, zeros, dem_s, zeros, sunlit,
            top_height=cfg.isccp_top_height,
            top_height_direction=cfg.isccp_top_height_direction)
        if cfg.run_isccp:
            out["isccp"] = isccp

    if cfg.run_misr:
        out["misr"] = misr_simulator(frac_out, zlo, inp.t, dtau_s,
                                     zeros, sunlit)

    if cfg.run_modis:
        # per-subcolumn liquid/ice tau: dtau_s partitioned by the
        # geometric-optics LWC/re ratio (modis_L2_simulator_oneTau)
        rl_um = (inp.rl * 1e6)[:, None, :]
        ri_um = (inp.ri * 1e6)[:, None, :]
        lw = mr[I_LSCLIQ] / torch.clamp(rl_um, min=1e-6)
        iw = mr[I_LSCICE] / (0.93 * torch.clamp(ri_um, min=1e-6))
        liq_frac = torch.where(lw + iw > 0.0,
                               lw / torch.clamp(lw + iw, min=1e-30), zero)
        tau_sub = torch.where(ls_cld, dtau_s[:, None, :], zero)
        l2 = modis_l2_simulator(
            inp.t, play, inp.ple,
            tau_sub * liq_frac, tau_sub * (1.0 - liq_frac),
            rl_um.expand(tau_sub.shape), ri_um.expand(tau_sub.shape),
            isccp["boxtau"], isccp["boxptop"])
        l3 = modis_l3_simulator(l2["phase"], l2["ctp"], l2["tau"],
                                l2["size"])
        out["modis"] = {"l2": l2, **l3}

    if cfg.use_vgrid:
        zl_s, zu_s = csat_vgrid_bounds(cfg.nlr, cfg.csat_vgrid)

        def regrid(y, log=False):
            return change_vertical_grid(y, inp.zle, zl_s, zu_s,
                                        log_units=log)

    sr = None
    if cfg.run_lidar:
        lid = lidar_simulator(
            play, inp.ple, inp.t,
            mr[I_LSCLIQ], mr[I_LSCICE],
            torch.zeros_like(mr[I_LSCLIQ]), torch.zeros_like(mr[I_LSCLIQ]),
            inp.rl, inp.ri, inp.rl, inp.ri,
            ice_type=cfg.lidar_ice_type)
        if cfg.use_vgrid:
            # statistics on the stat grid (COSP_STATS: regrid beta_tot,
            # betamol and pressure, then run the LMD/IPSL diagnostics)
            pnorm_s = regrid(lid["pnorm"])
            pmol_s = regrid(lid["pmol"][:, None, :])[:, 0]
            pplay_s = regrid(play[:, None, :])[:, 0]
            st = lidar_stats(pnorm_s, pmol_s, lid["refl"],
                             inp.frland, pplay_s)
            # undefined bins (below the model surface / no molecular
            # signal): the reference's sc_ratio = R_UNDEF/R_UNDEF = 1.0
            # is neither cloud (>5) nor attenuated (<=0.01), so such
            # bins are effectively ignored (llnl_stats.F90:62-70);
            # mirror that with an explicit 1.0 sentinel
            sr = torch.where(pmol_s[:, None, :] > 0.0,
                             pnorm_s / torch.clamp(pmol_s[:, None, :],
                                                   min=1e-38), 1.0 + zero)
        else:
            st = lidar_stats(lid["pnorm"], lid["pmol"], lid["refl"],
                             inp.frland, play)
            sr = lid["pnorm"] / torch.clamp(lid["pmol"][:, None, :],
                                            min=1e-38)
        out["lidar"] = {**lid, **st}

    if cfg.run_radar:
        rh = torch.clamp(inp.qv / torch.clamp(_qsat(inp.t, play), min=1e-12),
                         0.0, 1.0) * 100.0
        hm = torch.stack([mr[i] for i in PRESENT]) * 1e3
        re = torch.stack([re_cld[i] for i in PRESENT])
        rad = quickbeam_simulator(inp.zle[:, :-1] / 1000.0, play / 100.0,
                                  inp.t - 273.15, rh, hm, re,
                                  classes=PRESENT)
        del hm, re
        dbze = regrid(rad["dbze"], log=True) if cfg.use_vgrid \
            else rad["dbze"]
        out["radar"] = {**rad, "cfad_dbze": radar_cfad(dbze)}
        if sr is not None:
            if cfg.use_vgrid:
                # stat-grid profiles are ground-ascending; the
                # first-attenuation scan walks top->surface
                # (llnl_stats.F90:109), so flip, scan, flip back
                freq, tcc = lidar_only_freq_cloud(sr.flip(-1),
                                                  dbze.flip(-1))
                freq = freq.flip(-1)
            else:
                freq, tcc = lidar_only_freq_cloud(sr, dbze)
            out["radar"]["lidar_only_freq_cloud"] = freq
            out["radar"]["radar_lidar_tcc"] = tcc

    return out


def _qsat(t, p_pa):
    """Saturation specific humidity (Magnus over water; replaces
    GEOS_QSAT for the radar RH input)."""
    es = 610.94 * torch.exp(17.625 * (t - 273.15)
                            / torch.clamp(t - 30.11, min=1.0))
    return 0.622 * es / torch.clamp(p_pa - 0.378 * es, min=1.0)
