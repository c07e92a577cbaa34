"""QuickBeam CloudSat radar simulator (94 GHz reflectivity + CFAD).

Port of geosradiation_gridcomp_tpu/satsim/radar.py (quickbeam's
radar_simulator.f90, dsd.f90, zeff.f90, gases.f90, optics_lib.f90 and
the llnl CFAD/radar statistics):
  * Mie efficiencies are numpy tables over (temperature, particle size)
    for liquid-water and solid-ice spheres, built at first use from a
    vectorized Mie series (quickbeam's own mie-table idea); the simulator
    only gathers and integrates. This module keeps its own numpy copy of
    the refractive indices, the Mie series and the tables' code.
  * Ice/snow/graupel use equivalent-volume solid-ice spheres
    (radar_simulator.f90 "equivalent volume approach", rho_eff = 917).
  * The per-volume DSD loops are vectorized closed forms per hydrometeor
    class; attenuation path integrals are cumsums.
  * Liquid refractive index: Ray (1972) Debye form as in optics_lib
    m_wat; ice: Maetzler (2006) microwave model.

On a card (kernels.twins.use_kernel) quickbeam_simulator launches kernel
K11 (radar_cuda.py, csrc/quickbeam.cu): the DSD integrals as weighted
sums of each present class's N(D), evaluated in registers, the path
integral and dBZe in one launch over every point, no N(D) plane written;
the gas path stays in PyTorch (gas_path). Otherwise (the CPU, or inside
twins()) it runs the plain twin below, K11's reference: the DSD planes
are [points, subcolumns, levels, 85 sizes], at 8192 x 50 x 72 one
float32 plane is 10 GB, so the twin runs the points in blocks (each point
is independent and nothing is drawn, so the result is that of one
unblocked call). Which classes it integrates is static (`classes`, a
tuple): a class absent at a point adds exact zeros there, so a caller
that knows a class is never present (cosp's convective classes) leaves
its planes out, and no call reads the device to decide. Its tables go to
the device once per device (tables.on_device). `counts()` says, per key
of shapes the radar has run at, how it blocked the points and the bytes
of the DSD planes one call materialises (none on K11's path, which also
counts the (volume, class) pairs it integrated).

Hydrometeor classes default to the GEOS 9-class table
(cosp_constants.F90:116-127): LSL, LSI, LSR, LSS, CVL, CVI, CVR, CVS,
LSG, read from quickbeam.npz.
"""

import functools
import math

import numpy as np
import torch

from ..kernels.twins import use_kernel
from ..tables import load64, on_device

R_UNDEF = -1.0e30
R_GROUND = -1.0e20
MISSING_DBZ = -999.0
# CFAD configuration (cosp_constants.F90:61-65)
DBZE_BINS, DBZE_MIN, DBZE_MAX = 15, -100.0, 80.0
CFAD_ZE_MIN, CFAD_ZE_WIDTH = -50.0, 5.0

# discrete particle sizes: 85 log-spaced in [0.1, 10000] um
# (radar_simulator_types.f90:12-14, cosp_types.F90:1173-1180)
ND = 85
D_GRID_UM = np.exp(np.linspace(np.log(0.1), np.log(10000.0), ND))

FREQ_GHZ = 94.0
K2_94 = 0.75                   # |K|^2 default at 94 GHz (zeff.f90:48-52)
RHO_ICE = 917.0

# bytes of one [points, subcolumns, levels, ND] float32 plane per block
PLANE_BYTES = 1 << 30

# per (classes, [np, ncol, nlev], dtype) that quickbeam_simulator has run
# at: its blocks, points per block, classes and plane bytes (on K11's
# path also `kernel` and its device counter `present`)
_COUNTS = {}


def counts():
    """Per key of shapes that quickbeam_simulator has run at (the
    classes, the [points, subcolumns, levels] of a plane and its dtype):
    `blocks`, `points_per_block`, `classes` (the number integrated),
    `points` and `plane_bytes`, the bytes of the [block, ncol, nlev, ND]
    N(D) planes, one a class and block, that one call materialises. They
    are recorded when the radar runs (eagerly, or the warm-up and capture
    of a captured caller); a replay repeats that work, so they describe
    every call of the key. K11's path records one block of every point
    and plane_bytes 0, since it writes no plane, and also `kernel` (True)
    and `present`: the (point, subcolumn, level, class) quadruples whose
    class it integrated (q > 1e-12) in the key's last call, kept on the
    device by the kernel and read here, which synchronises. Copies, as
    diagnostics.counts() gives."""
    return {k: {n: int(x) if isinstance(x, torch.Tensor) else x
                for n, x in v.items()} for k, v in _COUNTS.items()}


# ---------------------------------------------------------------------------
# refractive indices and Mie tables (numpy, first use)
# ---------------------------------------------------------------------------

def m_wat(freq_ghz, t_c):
    """Complex refractive index of liquid water (optics_lib.f90 m_wat,
    Ray 1972 Debye relaxation)."""
    t = np.asarray(t_c, np.float64)
    ld = 100.0 * 2.99792458e8 / (freq_ghz * 1e9)    # cm
    es = 78.54 * (1 - (4.579e-3 * (t - 25.0) + 1.19e-5 * (t - 25.0) ** 2
                       - 2.8e-8 * (t - 25.0) ** 3))
    ei = 5.27137 + 0.021647 * t - 0.00131198 * t * t
    a = -(16.8129 / (t + 273.0)) + 0.0609265
    ls = 0.00033836 * np.exp(2513.98 / (t + 273.0))
    sg = 12.5664e8
    tm1 = (ls / ld) ** (1.0 - a)
    cos1 = np.cos(0.5 * a * np.pi)
    sin1 = np.sin(0.5 * a * np.pi)
    e_r = ei + (es - ei) * (1.0 + tm1 * sin1) \
        / (1.0 + 2 * tm1 * sin1 + tm1 ** 2)
    e_i = (es - ei) * tm1 * cos1 / (1.0 + 2 * tm1 * sin1 + tm1 ** 2) \
        + sg * ld / 1.885e11
    return np.sqrt(e_r + 1j * e_i)


def m_ice(freq_ghz, t_c):
    """Complex refractive index of ice in the microwave, Maetzler (2006)
    model (replaces the Warren LUT of optics_lib m_ice; agrees to ~1%
    at 94 GHz)."""
    t = np.minimum(np.asarray(t_c, np.float64) + 273.15, 273.15)
    theta = 300.0 / t - 1.0
    eps_r = 3.1884 + 9.1e-4 * (t - 273.0)
    alpha = (0.00504 + 0.0062 * theta) * np.exp(-22.1 * theta)
    # beta = B1/T * exp(b/T)/(exp(b/T)-1)^2 + B2*f^2  (Maetzler 2006)
    b1, b, b2 = 0.0207, 335.0, 1.16e-11
    f = freq_ghz
    ebt = np.exp(b / t)
    beta = b1 / t * ebt / (ebt - 1.0) ** 2 + b2 * f * f
    eps_i = alpha / f + beta * f
    return np.sqrt(eps_r + 1j * eps_i)


def mie_qext_qbsca(m, x):
    """Vectorized Mie efficiencies (optics_lib mieint equivalent).

    m: complex scalar; x: [n] size parameters. Returns (qext, qbsca).
    """
    x = np.asarray(x, np.float64)
    nmax = int(np.max(x + 4.0 * x ** (1 / 3) + 4.0)) + 2
    y = m * x
    # downward recurrence for logarithmic derivative D_n(y)
    nstart = nmax + 15
    d = np.zeros((nstart + 1,) + y.shape, np.complex128)
    for n in range(nstart, 0, -1):
        d[n - 1] = n / y - 1.0 / (d[n] + n / y)
    psi0 = np.sin(x)
    psi1 = np.sin(x) / x - np.cos(x)
    chi0 = np.cos(x)
    chi1 = np.cos(x) / x + np.sin(x)
    xi0 = psi0 - 1j * chi0
    xi1 = psi1 - 1j * chi1
    qext = np.zeros_like(x)
    qsca_b = np.zeros_like(y)
    psi_nm1, psi_n = psi0, psi1
    xi_nm1, xi_n = xi0, xi1
    for n in range(1, nmax + 1):
        dn = d[n]
        an = ((dn / m + n / x) * psi_n - psi_nm1) \
            / ((dn / m + n / x) * xi_n - xi_nm1)
        bn = ((dn * m + n / x) * psi_n - psi_nm1) \
            / ((dn * m + n / x) * xi_n - xi_nm1)
        qext += (2 * n + 1) * (an + bn).real
        qsca_b += (2 * n + 1) * ((-1.0) ** n) * (an - bn)
        psi_np1 = (2 * n + 1) / x * psi_n - psi_nm1
        xi_np1 = (2 * n + 1) / x * xi_n - xi_nm1
        psi_nm1, psi_n = psi_n, psi_np1
        xi_nm1, xi_n = xi_n, xi_np1
    qext *= 2.0 / x ** 2
    qbsca = np.abs(qsca_b) ** 2 / x ** 2
    return qext, qbsca


# temperature grids for the efficiency tables (1 K; finer than the
# reference's 5 K Ze-scaling cache)
T_GRID_LIQ = np.arange(-60.0, 51.0, 1.0)
T_GRID_ICE = np.arange(-90.0, 21.0, 1.0)


@functools.lru_cache(maxsize=1)
def mie_tables():
    """(qext, qbsca) tables [ntemp, nd] for liquid and solid-ice spheres
    at 94 GHz over D_GRID_UM."""
    wl_m = 2.99792458 / (FREQ_GHZ * 10.0)
    x = np.pi * (D_GRID_UM * 1e-6) / wl_m
    ql_e = np.zeros((len(T_GRID_LIQ), ND))
    ql_b = np.zeros_like(ql_e)
    for i, t in enumerate(T_GRID_LIQ):
        ql_e[i], ql_b[i] = mie_qext_qbsca(m_wat(FREQ_GHZ, t), x)
    qi_e = np.zeros((len(T_GRID_ICE), ND))
    qi_b = np.zeros_like(qi_e)
    for i, t in enumerate(T_GRID_ICE):
        qi_e[i], qi_b[i] = mie_qext_qbsca(m_ice(FREQ_GHZ, t), x)
    return (ql_e.astype(np.float32), ql_b.astype(np.float32),
            qi_e.astype(np.float32), qi_b.astype(np.float32))


@functools.lru_cache(maxsize=1)
def hclass():
    """GEOS 9-class hydrometeor table (cosp_constants.F90:116-127)."""
    d = load64("quickbeam")
    return {k: np.asarray(d["hclass_" + k])
            for k in ("type", "phase", "apm", "bpm", "rho",
                      "p1", "p2", "p3")}


# ---------------------------------------------------------------------------
# DSDs (dsd.f90) - number concentration N(D) [cm^-3 um^-1]
# ---------------------------------------------------------------------------

def _dsd_number(q_gkg, re_um, rho_a, cls, D):
    """N(D) [cm^-3 um^-1] for one hydrometeor class; all array args
    broadcast against [..., nd]. q in g/kg, re in um."""
    dtype = int(cls["dtype"])
    apm, bpm = cls["apm"], cls["bpm"]
    rho_c = cls["rho"]
    p1, p2, p3 = cls["p1"], cls["p2"], cls["p3"]
    if rho_c > 0 and apm < 0:
        apm = (np.pi / 6.0) * rho_c
        bpm = 3.0
    qx = q_gkg[..., None]
    rex = re_um[..., None]
    rax = rho_a[..., None]
    Dx = D  # [nd], um

    if dtype == 1:
        # modified gamma, vu = p3, D0 from Re (dsd.f90 case 1, p1=-1)
        vu = p3
        d0_def = math.gamma(vu) / math.gamma(vu + 1.0) * p2
        d0 = torch.where(rex > 0.0,
                         2.0 * rex * math.gamma(vu + 2.0)
                         / math.gamma(vu + 3.0), d0_def)
        fc = ((Dx * 1e-6) ** (vu - 1.0) * torch.exp(-Dx / d0)
              / (apm * (d0 * 1e-6) ** (vu + bpm)
                 * math.gamma(vu + bpm))) * 1e-12
        return fc * rax * (qx * 1e-3)
    if dtype == 2:
        # exponential with fixed intercept N0 = p1 (rain/snow/graupel,
        # dsd.f90 case 2): lambda from Re when provided, else from the
        # Re derived for fixed-N0 distributions
        # (radar_simulator.f90:186-200): ld = (apm G(1+bpm) N0 /
        # (rho_a q))^(1/(1+bpm)), Re = 1.5e6/ld
        n0 = p1
        ld_fix = (apm * math.gamma(1.0 + bpm) * n0
                  / torch.clamp(rax * qx * 1e-3, min=1e-30)) \
            ** (1.0 / (1.0 + bpm))               # 1/m
        ld_um = torch.where(rex > 0.0, 1.5 / torch.clamp(rex, min=1e-3),
                            ld_fix * 1e-6)       # 1/um
        return n0 * torch.exp(-ld_um * Dx) * 1e-12
    if dtype == 5:
        # lognormal with sigma_g = exp(p3), rg from Re (case 5, p1=-1)
        log_sg = p3
        rg_def = p2
        rg = torch.where(rex > 0.0, rex * float(np.exp(-2.5 * log_sg ** 2)),
                         rg_def)
        tmp2 = (bpm * log_sg) ** 2
        fc = 0.5 * (1.0 / ((2.0 * rg * 1e-6) ** bpm * apm
                           * float(np.sqrt(2.0 * np.pi)) * log_sg
                           * Dx * 0.5 * 1e-6)
                    * torch.exp(-0.5 * ((torch.log(0.5 * Dx / rg)
                                         / log_sg) ** 2 + tmp2))) * 1e-12
        return fc * rax * (qx * 1e-3)
    raise NotImplementedError(f"dsd type {dtype}")


def _trapz(y, x):
    """Trapezoid integral along the last axis (replaces avint)."""
    return (0.5 * (y[..., 1:] + y[..., :-1])
            * (x[..., 1:] - x[..., :-1])).sum(dim=-1)


def gases_liebe(p_hpa, t_k, rh, f_ghz=FREQ_GHZ):
    """Two-way gaseous attenuation (dB/km) at f_ghz: Liebe MPM O2/H2O
    line model (gases.f90:1-185), vectorized over the line axis."""
    d = load64("quickbeam")

    def c(name):
        return on_device(d[name], p_hpa.device, p_hpa.dtype)
    v0 = c("gas_v0")
    a1, a2, a3 = (c("gas_a" + s) for s in "123")
    a4, a5, a6 = (c("gas_a" + s) for s in "456")
    v1 = c("gas_v1")
    b1, b2, b3 = (c("gas_b" + s) for s in "123")
    f = f_ghz
    th = 300.0 / t_k
    e = (rh * th ** 5) / (41.45 * 10.0 ** (9.834 * th - 10.0))
    p = p_hpa / 10.0 - e
    px, thx, ex = p[..., None], th[..., None], e[..., None]

    gm = a3 * (px * thx ** (0.8 - a4) + 1.1 * ex * thx)
    delt = a5 * px * thx ** a6
    x = (v0 - f) ** 2 + gm ** 2
    y = (v0 + f) ** 2 + gm ** 2
    fpp = (1.0 / x + 1.0 / y) * (gm * f / v0) \
        - (delt * f / v0) * ((v0 - f) / x - (v0 + f) / x)
    s = a1 * px * thx ** 3 * torch.exp(a2 * (1.0 - thx))
    term1 = (fpp * s).sum(dim=-1)

    gm0 = 5.6e-3 * (p + 1.1 * e) * th ** 0.8
    a0 = 3.07e-4
    ap = 1.4 * (1.0 - 1.2 * f ** 1.5 * 1e-5) * 1e-10
    term2 = (2 * a0 / (gm0 * (1 + (f / gm0) ** 2) * (1 + (f / 60.) ** 2))
             + ap * p * th ** 2.5) * f * p * th ** 2

    gmw = b3 * (px * thx ** 0.8 + 4.8 * ex * thx)
    xw = (v1 - f) ** 2 + gmw ** 2
    yw = (v1 + f) ** 2 + gmw ** 2
    fppw = (1.0 / xw + 1.0 / yw) * (gmw * f / v1)
    sw = b1 * ex * thx ** 3.5 * torch.exp(b2 * (1.0 - thx))
    term3 = (fppw * sw).sum(dim=-1)

    term4 = (1.4e-6 * p + 5.41e-5 * e * th ** 3) * f * e * th ** 2.5
    return 0.182 * f * (term1 + term2 + term3 + term4)


def gas_path(hgt_km, p_hpa, t_c, rh):
    """Two-way gaseous attenuation from the radar (TOA) to each level (dB),
    [np, 1, nlev]: the trapezoid cumulative over height of gases_liebe."""
    dz = (hgt_km[:, 1:] - hgt_km[:, :-1]).abs()[:, None, :]
    g_vol = gases_liebe(p_hpa, t_c + 273.15, rh)     # [np, nlev]
    gm = 0.5 * (g_vol[:, 1:] + g_vol[:, :-1])[:, None, :] * dz
    return torch.cat([torch.zeros_like(gm[..., :1]),
                      torch.cumsum(gm, dim=-1)], dim=-1)


def quickbeam_simulator(hgt_km, p_hpa, t_c, rh, hm_gkg, re_um,
                        k2=K2_94, do_ray=False, use_gas_abs=True,
                        classes=None):
    """CloudSat 94 GHz effective reflectivity per subcolumn profile.

    Args (TOA-first level axis = "closest to the radar first"):
      hgt_km/p_hpa/t_c/rh: [np, nlev] gridbox profiles.
      hm_gkg: [nclass, np, ncol, nlev] hydrometeor mixing ratios (g/kg).
      re_um:  [nclass, np, ncol, nlev] effective radii (um); 0 = derive
        (exponential fixed-N0 classes) or use class default.
      classes: the hydrometeor classes (rows of the 9-class table) that
        the nclass planes hold, in order, a static tuple; by default
        range(nclass), as the reference integrates every class. A class
        left out adds what an absent one would: exact zeros.

    K11 (radar_cuda.quickbeam_kernel) where kernels.twins.use_kernel
    holds; otherwise the plain twin, whose points run in blocks of as many
    as keep one [block, ncol, nlev, ND] float32 plane within PLANE_BYTES.

    Returns dict: dbze [np, ncol, nlev] attenuated reflectivity (dBZe),
    ze_non (unattenuated), h_atten/g_atten [np, ncol/1, nlev] (dB).
    """
    classes = tuple(range(hm_gkg.shape[0]) if classes is None else classes)
    if len(classes) != hm_gkg.shape[0] or len(classes) != re_um.shape[0]:
        raise ValueError(f"quickbeam_simulator: {len(classes)} classes "
                         f"for {hm_gkg.shape[0]} hm and {re_um.shape[0]} "
                         f"re planes")
    if use_kernel(hm_gkg):
        from .radar_cuda import quickbeam_kernel   # it imports this module
        return quickbeam_kernel(hgt_km, p_hpa, t_c, rh, hm_gkg, re_um,
                                classes, k2, do_ray, use_gas_abs)
    npnt = hgt_km.shape[0]
    per_point = hm_gkg[0, 0].numel() * ND * hm_gkg.element_size()
    points_per_block = max(1, PLANE_BYTES // per_point)
    _COUNTS[(classes, tuple(hm_gkg.shape[1:]), str(hm_gkg.dtype))] = dict(
        blocks=-(-npnt // points_per_block),
        points_per_block=points_per_block, classes=len(classes),
        points=npnt, plane_bytes=len(classes) * npnt * per_point)
    blocks = [_quickbeam_block(
        hgt_km[s:s + points_per_block], p_hpa[s:s + points_per_block],
        t_c[s:s + points_per_block], rh[s:s + points_per_block],
        hm_gkg[:, s:s + points_per_block], re_um[:, s:s + points_per_block],
        classes, k2, do_ray, use_gas_abs)
        for s in range(0, npnt, points_per_block)]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def _quickbeam_block(hgt_km, p_hpa, t_c, rh, hm_gkg, re_um, classes, k2,
                     do_ray, use_gas_abs):
    """quickbeam_simulator on one block of points: plane i holds class
    classes[i]."""
    hc = hclass()
    dev, fdt = t_c.device, t_c.dtype
    ql_e, ql_b, qi_e, qi_b = [on_device(t, dev) for t in mie_tables()]
    D = on_device(D_GRID_UM, dev, torch.float32)
    rho_a = (p_hpa * 100.0) / (287.0 * (t_c + 273.15))     # [np, nlev]

    it_liq = torch.clamp(torch.round(t_c - float(T_GRID_LIQ[0])).to(
        torch.int32), 0, len(T_GRID_LIQ) - 1).long()
    it_ice = torch.clamp(torch.round(t_c - float(T_GRID_ICE[0])).to(
        torch.int32), 0, len(T_GRID_ICE) - 1).long()

    wl_m = 2.99792458 / (FREQ_GHZ * 10.0)
    const = (wl_m ** 4 / np.pi ** 5) / k2
    cr = 10.0 / np.log(10.0)

    shape = hm_gkg.shape[1:]
    zero = torch.zeros((), dtype=fdt, device=dev)
    z_vol = torch.zeros(shape, dtype=fdt, device=dev)
    z_ray = torch.zeros(shape, dtype=fdt, device=dev)
    kr_vol = torch.zeros(shape, dtype=fdt, device=dev)
    for i, tp in enumerate(classes):
        cls = {k: float(hc[k][tp]) for k in hc}
        cls["dtype"] = hc["type"][tp]
        q = hm_gkg[i]                        # [np, ncol, nlev]
        n_d = _dsd_number(q, re_um[i], rho_a[:, None, :], cls, D)
        phase = int(hc["phase"][tp])
        apm, bpm, rho_c = cls["apm"], cls["bpm"], cls["rho"]
        if rho_c > 0 and apm < 0:
            apm = (np.pi / 6.0) * rho_c
            bpm = 3.0
        if phase == 1:
            # equivalent-volume solid-ice spheres
            # (radar_simulator.f90:300-330)
            if rho_c < 0:
                deq = ((6.0 / np.pi * apm / RHO_ICE) ** (1.0 / 3.0)
                       * (D * 1e-6) ** (bpm / 3.0)) * 1e6
            else:
                deq = D * (rho_c / RHO_ICE) ** (1.0 / 3.0)
            # interpolate ice efficiencies at Deq on the D grid
            logD = torch.log(D)
            pos = torch.clamp((torch.log(deq) - logD[0])
                              / (logD[1] - logD[0]), 0, ND - 1)
            i0 = torch.clamp(pos.to(torch.int32), 0, ND - 2).long()
            w = pos - i0
            qe_t = qi_e[it_ice]              # [np, nlev, nd]
            qb_t = qi_b[it_ice]
            qe = ((1 - w) * qe_t[..., i0] + w * qe_t[..., i0 + 1]
                  )[:, None, :, :]
            qb = ((1 - w) * qb_t[..., i0] + w * qb_t[..., i0 + 1]
                  )[:, None, :, :]
            d_int = deq
        else:
            qe = ql_e[it_liq][:, None, :, :]
            qb = ql_b[it_liq][:, None, :, :]
            d_int = D
        d0_m = d_int * 1e-6                  # [nd]
        n0_si = n_d * 1e12                   # m^-3 m^-1
        del n_d
        eta = _trapz(qb * n0_si * d0_m ** 2, d0_m)
        ksum = _trapz(qe * n0_si * d0_m ** 2, d0_m)
        present = q > 1e-12
        z_vol = z_vol + torch.where(
            present, const * eta * 0.25 * np.pi * 1e18, zero)
        kr_vol = kr_vol + torch.where(
            present, ksum * 0.25 * np.pi * 1000.0 * cr, zero)
        if do_ray:
            zr = _trapz(n0_si * d0_m ** 6, d0_m)
            z_ray = z_ray + torch.where(present, zr * 1e18, zero)

    # attenuation path integrals from the radar (TOA) down: trapezoid
    # cumulative over height (path_integral in math_lib)
    dz = (hgt_km[:, 1:] - hgt_km[:, :-1]).abs()[:, None, :]
    kr_mid = 0.5 * (kr_vol[..., 1:] + kr_vol[..., :-1])
    seg = kr_mid * dz
    a_to_vol = 2.0 * torch.cat([torch.zeros_like(seg[..., :1]),
                                torch.cumsum(seg, dim=-1)], dim=-1)
    if use_gas_abs:
        g_to_vol = gas_path(hgt_km, p_hpa, t_c, rh)
    else:
        g_to_vol = torch.zeros_like(a_to_vol)

    hydro = z_vol > 0.0
    missing = torch.full((), MISSING_DBZ, dtype=fdt, device=dev)
    ze_non = torch.where(hydro, 10.0 * torch.log10(
        torch.clamp(z_vol, min=1e-30)), missing)
    dbze = torch.where(hydro, ze_non - a_to_vol - g_to_vol, missing)
    out = dict(dbze=dbze, ze_non=ze_non, h_atten=a_to_vol,
               g_atten=g_to_vol)
    if do_ray:
        out["ze_ray"] = torch.where(
            z_ray > 0.0, 10.0 * torch.log10(torch.clamp(z_ray, min=1e-30)),
            missing)
    return out


def radar_cfad(dbze):
    """CFAD of dBZe (COSP_CFAD, llnl_stats.F90:7-34): 15 bins of 5 dB
    from -50 dBZe. dbze: [np, ncol, nlev] -> [np, 15, nlev]."""
    np_, ncol, nlev = dbze.shape
    inrange = (dbze >= DBZE_MIN) & (dbze <= DBZE_MAX)
    ib = torch.clamp(torch.ceil((dbze - CFAD_ZE_MIN) / CFAD_ZE_WIDTH
                                ).to(torch.int32) - 1, 0, DBZE_BINS - 1)
    onehot = (ib[..., None] == torch.arange(DBZE_BINS, device=dbze.device)) \
        & inrange[..., None]
    cfad = onehot.sum(dim=1).to(dbze.dtype) / ncol
    return cfad.transpose(1, 2)


def lidar_only_freq_cloud(sr, dbze):
    """Lidar-sees/radar-misses cloud frequency + total cloud cover
    (COSP_LIDAR_ONLY_CLOUD, llnl_stats.F90:37-80).

    sr: [np, ncol, nlev] lidar scattering ratio; dbze: same shape.
    Returns (freq [np, nlev], tcc [np])."""
    s_cld, s_att = 5.0, 0.01
    # first fully-attenuated level from the top
    attenuated = sr <= s_att
    is_first_att = attenuated & (torch.cumsum(
        attenuated.to(torch.int32), dim=-1) == 1)
    radar_miss = dbze < -30.0
    lidar_sees = (sr > s_cld) | is_first_att
    freq = (radar_miss & lidar_sees).to(sr.dtype).mean(dim=1)
    cloudy_col = ((radar_miss & lidar_sees) | ~radar_miss).any(dim=-1)
    tcc = cloudy_col.to(sr.dtype).mean(dim=1)
    return freq, tcc
