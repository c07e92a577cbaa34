"""MODIS cloud-retrieval simulator (L2 pixel + L3 gridbox aggregation).

Port of geosradiation_gridcomp_tpu/satsim/modis.py (modis_simulator.F90:
modis_L2_simulator_twoTaus :147+, modis_L3_simulator :385+, optics fits
from Steve Platnick, two-stream + adding-doubling NIR reflectance):
  * the serial "integrate to tau limit" loops (cloud_top_pressure,
    weight_by_extinction) are closed-form cumulative-sum expressions
    with a per-layer effective optical-depth clip;
  * the per-layer adding-doubling recursion is a loop over levels;
  * the re retrieval evaluates all trial radii at once and does a
    vectorized bracketed linear interpolation to the observed NIR
    reflectance.
"""

import numpy as np
import torch

from ..tables import on_device
from .icarus import digitize, histogram

R_UNDEF = -1.0e30
RE_FILL = -999.0

# algorithmic parameters (modis_simulator.F90:55-99)
ICE_DENSITY = 0.93
MIN_TAU = 0.3
CO2_SLICING_PLIMIT = 700.0e2        # Pa
CO2_SLICING_TAULIMIT = 1.0
PHASE_TAULIMIT = 1.0
SIZE_TAULIMIT = 2.0
PHASE_THRESHOLD = 0.7
PHASE_NONE, PHASE_LIQ, PHASE_ICE, PHASE_UNDET = 0, 1, 2, 3
RE_WATER_MIN, RE_WATER_MAX = 4.0, 30.0
RE_ICE_MIN, RE_ICE_MAX = 5.0, 90.0
NUM_TRIAL_RES = 15
TRIAL_RE_W = np.linspace(RE_WATER_MIN, RE_WATER_MAX, NUM_TRIAL_RES)
TRIAL_RE_I = np.linspace(RE_ICE_MIN, RE_ICE_MAX, NUM_TRIAL_RES)

TAU_HIST_EDGES = np.array([MIN_TAU, 1.3, 3.6, 9.4, 23.0, 60.0, 1e30])
PRES_HIST_EDGES = np.array([0., 18000., 31000., 44000., 56000., 68000.,
                            80000., 1e30])
HIGH_P, LOW_P = 440.0e2, 680.0e2


def _g_nir(phase_is_liquid, re):
    """Asymmetry parameter fit, MODIS band 7 (get_g_nir)."""
    if phase_is_liquid:
        re_s = torch.clamp(re, min=RE_WATER_MIN)
        small = 0.8027 + re_s * (-1.0496e-2 + re_s * 1.7071e-3)
        re_b = torch.clamp(re, max=RE_WATER_MAX)
        big = 0.7931 + re_b * (5.3087e-3 + re_b * -7.4995e-5)
        return torch.where(re < 8.0, small, big)
    re_c = torch.clamp(re, RE_ICE_MIN, RE_ICE_MAX)
    return 0.7432 + re_c * (4.5563e-3 + re_c * -2.8697e-5)


def _ssa_nir(phase_is_liquid, re):
    """Single-scattering albedo fit, MODIS band 7 (get_ssa_nir)."""
    if phase_is_liquid:
        re_c = torch.clamp(re, RE_WATER_MIN, RE_WATER_MAX)
        return 1.0008 + re_c * (-2.5626e-3 + re_c * 1.6024e-5)
    re_c = torch.clamp(re, RE_ICE_MIN, RE_ICE_MAX)
    return 0.9994 + re_c * (-4.5199e-3
                            + re_c * (3.9370e-5 + re_c * -1.5235e-7))


def _two_stream_rt(tau, g, w0):
    """Delta-Eddington two-stream layer (R, T), diffuse beam
    (two_stream, beam=2 branch)."""
    f = g * g
    taup = (1.0 - w0 * f) * tau
    w0p = (1.0 - f) * w0 / torch.clamp(1.0 - w0 * f, min=1e-12)
    gp = (g - f) / torch.clamp(1.0 - f, min=1e-12)
    g1 = (7.0 - w0p * (4.0 + 3.0 * gp)) / 4.0
    g2 = -(1.0 - w0p * (4.0 - 3.0 * gp)) / 4.0
    # conservative limit
    ref_c = g1 * taup / (1.0 + g1 * taup)
    tra_c = 1.0 - ref_c
    rk = torch.sqrt(torch.clamp(g1 * g1 - g2 * g2, min=1e-12))
    beta = (rk - g1) / (rk + g1)
    e1 = torch.clamp(rk * taup, max=500.0)
    ef1 = torch.exp(-e1)
    ef2 = torch.exp(-2.0 * e1)
    den = (rk + g1) * (1.0 - beta * ef2)
    ref_n = g2 * (1.0 - ef2) / den
    tra_n = 2.0 * rk * ef1 / den
    cons = w0 > 0.9999999
    return torch.where(cons, ref_c, ref_n), torch.where(cons, tra_c, tra_n)


def _adding_doubling(refl, tran):
    """Total reflectance of stacked layers (adding_doubling): a loop over
    the level axis (last)."""
    rc = torch.zeros_like(refl[..., 0])
    tc = torch.ones_like(rc)
    for lev in range(refl.shape[-1]):
        r, t = refl[..., lev], tran[..., lev]
        den = torch.clamp(1.0 - rc * r, min=1e-12)
        rc, tc = rc + r * tc * tc / den, tc * t / den
    return rc


def _weight_to_tau_limit(dtau, f, tau_limit):
    """Extinction-weighted mean of per-layer f down to tau_limit
    (weight_by_extinction): closed-form with clipped increments."""
    cum_before = torch.cumsum(dtau, dim=-1) - dtau
    eff = torch.minimum(torch.clamp(tau_limit - cum_before, min=0.0), dtau)
    tot = eff.sum(dim=-1)
    return (eff * f).sum(dim=-1) / torch.clamp(tot, min=1e-12)


def _ctp_to_tau_limit(dtau, plev, tau_limit):
    """Extinction-weighted pressure down to tau_limit with linear-in-p
    layers (cloud_top_pressure): trapezoid + partial-step closed form."""
    p_top = plev[..., :-1]
    p_bot = plev[..., 1:]
    cum_before = torch.cumsum(dtau, dim=-1) - dtau
    eff = torch.minimum(torch.clamp(tau_limit - cum_before, min=0.0), dtau)
    contrib = p_top * eff + (p_bot - p_top) * eff * eff \
        / (2.0 * torch.clamp(dtau, min=1e-12))
    tot = eff.sum(dim=-1)
    return contrib.sum(dim=-1) / torch.clamp(tot, min=1e-12)


def _interpolate_to_min(x, y, yobs):
    """x minimizing |y - yobs| with bracketed linear root interpolation
    (interpolate_to_min); x: [n], y/yobs: [..., n] / [...]."""
    n = y.shape[-1]
    diff = y - yobs[..., None]
    i_min = torch.argmin(diff.abs(), dim=-1)

    def take(a, i):
        return torch.take_along_dim(a, i[..., None], dim=-1)[..., 0]
    d_at = take(diff, i_min)
    d_prev = take(diff, torch.clamp(i_min - 1, min=0))
    # bracket on the sign-change side (f:702-710)
    use_prev = (i_min > 0) & ((i_min == n - 1) | (d_prev * d_at < 0.0))
    lo = torch.where(use_prev, i_min - 1, i_min)
    hi = torch.clamp(lo + 1, 0, n - 1)
    d_lo = take(diff, lo)
    d_hi = take(diff, hi)
    xg = on_device(x, y.device, y.dtype)
    x_lo = xg[lo]
    x_hi = xg[hi]
    dd = d_hi - d_lo
    root = x_hi - d_hi * (x_hi - x_lo) / torch.where(
        dd.abs() > 1e-30, dd, torch.full_like(dd, 1e-30))
    return torch.where(d_lo * d_hi < 0.0, root, torch.full_like(root,
                                                                 RE_FILL))


def _retrieve_re(phase, tau, obs_refl):
    """Size retrieval: match two-stream NIR reflectance over trial radii
    (retrieve_re). phase: [..., ] int; tau/obs_refl: [...]."""
    out = torch.full_like(tau, RE_FILL)
    for ph, trial in ((PHASE_LIQ, TRIAL_RE_W), (PHASE_UNDET, TRIAL_RE_W),
                      (PHASE_ICE, TRIAL_RE_I)):
        liq = ph != PHASE_ICE
        tr = on_device(trial, tau.device, tau.dtype)
        pred, _ = _two_stream_rt(tau[..., None], _g_nir(liq, tr),
                                 _ssa_nir(liq, tr))
        re = _interpolate_to_min(trial, pred, obs_refl)
        out = torch.where(phase == ph, re, out)
    return out


def modis_l2_simulator(temp, play, plev, tau_liq, tau_ice,
                       size_liq, size_ice, isccp_tau, isccp_ctp_mb):
    """MODIS L2 retrievals per subcolumn (modis_L2_simulator_twoTaus).

    Args:
      temp/play: [np, nlev]; plev: [np, nlev+1] (Pa), TOA-first.
      tau_liq/tau_ice: [np, ncol, nlev] layer optical thicknesses.
      size_liq/size_ice: [np, ncol, nlev] particle sizes (micron).
      isccp_tau, isccp_ctp_mb: [np, ncol] from the ISCCP simulator
        (top_height=1); ctp in mb (its boxptop output).

    Returns dict: phase [np, ncol] int, ctp (Pa), tau, size (micron).
    """
    zero = torch.zeros((), dtype=tau_liq.dtype, device=tau_liq.device)
    tau_tot = tau_liq + tau_ice
    liq_frac = torch.where(tau_tot > 0.0,
                           tau_liq / torch.clamp(tau_tot, min=1e-12), zero)
    retr_tau = tau_tot.sum(dim=-1)
    cloudy = retr_tau >= MIN_TAU

    ctp = _ctp_to_tau_limit(tau_tot, plev[:, None, :], CO2_SLICING_TAULIMIT)
    int_liq = _weight_to_tau_limit(tau_tot, liq_frac, PHASE_TAULIMIT)
    phase = torch.where(
        int_liq >= PHASE_THRESHOLD, PHASE_LIQ,
        torch.where(int_liq <= 1.0 - PHASE_THRESHOLD, PHASE_ICE,
                    PHASE_UNDET))

    # NIR reflectance of the full column (compute_nir_reflectance)
    g_w = _g_nir(True, size_liq)
    w0_w = _ssa_nir(True, size_liq)
    g_i = _g_nir(False, size_ice)
    w0_i = _ssa_nir(False, size_ice)
    gbar = torch.where(tau_tot > 0.0,
                       (tau_liq * g_w + tau_ice * g_i)
                       / torch.clamp(tau_tot, min=1e-12), zero)
    w0bar = torch.where(
        tau_tot > 0.0,
        (tau_liq * g_w * w0_w + tau_ice * g_i * w0_i)
        / torch.clamp(gbar * tau_tot, min=1e-12), zero)
    r_lay, t_lay = _two_stream_rt(tau_tot, gbar, w0bar)
    clear_lay = tau_tot <= 0.0
    r_lay = torch.where(clear_lay, zero, r_lay)
    t_lay = torch.where(clear_lay, 1.0 + zero, t_lay)
    obs_refl = _adding_doubling(r_lay, t_lay)
    size = _retrieve_re(phase, retr_tau, obs_refl) * 1.0e-6
    size = torch.where((size < 0.0) & (size != R_UNDEF),
                       1.0e-6 * RE_FILL + zero, size)

    # thermal fallback below the CO2-slicing limit: use ISCCP CTP
    ctp = torch.where(cloudy & (ctp > CO2_SLICING_PLIMIT),
                      isccp_ctp_mb * 100.0, ctp)

    und = torch.full_like(retr_tau, R_UNDEF)
    return dict(
        phase=torch.where(cloudy, phase, PHASE_NONE),
        ctp=torch.where(cloudy, ctp, und),
        tau=torch.where(cloudy, retr_tau, und),
        size=torch.where(cloudy, size, und))


def modis_l3_simulator(phase, ctp, tau, size):
    """Gridbox L3 aggregation (modis_L3_simulator). Inputs [np, ncol]
    from modis_l2_simulator (ctp in Pa, size in m)."""
    np_, ncol = phase.shape
    dtype = tau.dtype
    zero = torch.zeros((), dtype=dtype, device=tau.device)
    undef = torch.full((), R_UNDEF, dtype=dtype, device=tau.device)
    valid = size > 0.0
    cld = (phase != PHASE_NONE) & valid
    wat = (phase == PHASE_LIQ) & valid
    ice = (phase == PHASE_ICE) & valid

    def cnt(m):
        return m.sum(dim=-1).to(dtype)

    n_tot, n_wat, n_ice = cnt(cld), cnt(wat), cnt(ice)
    n_high = cnt(cld & (ctp <= HIGH_P))
    n_low = cnt(cld & (ctp > LOW_P))
    n_mid = n_tot - n_high - n_low

    def mean_over(m, x, n):
        return torch.where(n > 0, torch.where(m, x, zero).sum(dim=-1)
                           / torch.clamp(n, min=1.0), undef)

    log_tau = torch.log10(torch.clamp(tau.abs(), min=1e-30))
    lwp_conv = 2.0 / 3.0 * 1000.0
    out = dict(
        cf_total=torch.clamp(n_tot / ncol, min=0.0),
        cf_water=torch.clamp(n_wat / ncol, min=0.0),
        cf_ice=torch.clamp(n_ice / ncol, min=0.0),
        cf_high=n_high / ncol, cf_mid=n_mid / ncol, cf_low=n_low / ncol,
        tau_total_mean=mean_over(cld, tau, n_tot),
        tau_water_mean=mean_over(wat, tau, n_wat),
        tau_ice_mean=mean_over(ice, tau, n_ice),
        tau_total_logmean=mean_over(cld, log_tau, n_tot),
        tau_water_logmean=mean_over(wat, log_tau, n_wat),
        tau_ice_logmean=mean_over(ice, log_tau, n_ice),
        size_water_mean=mean_over(wat, size, n_wat),
        size_ice_mean=mean_over(ice, size, n_ice),
        ctp_total_mean=mean_over(cld, ctp, torch.clamp(n_tot, min=1.0)),
        lwp_mean=torch.where(
            n_wat > 0, lwp_conv * torch.where(wat, size * tau, zero).sum(-1)
            / torch.clamp(n_wat, min=1.0), undef),
        iwp_mean=torch.where(
            n_ice > 0, lwp_conv * ICE_DENSITY
            * torch.where(ice, size * tau, zero).sum(-1)
            / torch.clamp(n_ice, min=1.0), undef))

    # tau x CTP joint histogram, pressure bins high->low in the output
    # (modis_simulator.F90:94-123): 6 tau x 7 pressure
    cell = digitize(tau, TAU_HIST_EDGES[1:-1]) * 7 \
        + digitize(ctp, PRES_HIST_EDGES[1:-1])
    fq = (histogram(cell, cld & (tau >= MIN_TAU), 42) / ncol).reshape(
        np_, 6, 7).to(dtype)
    out["tau_vs_ctp"] = fq.flip(-1)    # highest pressure first
    return out
