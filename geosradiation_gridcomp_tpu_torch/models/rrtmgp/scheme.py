"""RRTMGP scheme drivers: the reference's RRTMGP paths in the Solar and
Irrad GCs (GEOS_SolarGridComp.F90:4574-5302, GEOS_IrradGridComp.F90:
2114+) as functions: gas_concs -> k_dist gas optics -> band cloud optics
-> McICA sampling (GEN_MAX_RAN_OVERLAP with condensate inhomogeneity, the
GC's default path) -> generic rte solve.

Port of geosradiation_gridcomp_tpu/models/rrtmgp/scheme.py. Without a
coefficient file the RRTMG-reduced facade serves as the k-distribution:
its gas optics run kernels K3 (LW) and K5 (SW), rte_lw runs K4, the
McICA draws run K8 (ops/mcica_gmr_cuda.py), the LW table rows (the
Planck rows and the cloud rows of the LW band cloud optics) K9 and the
all-sky and clear-sky rte_sw K10 (rte_sw_cuda.py), each on CUDA tensors
(the plain twins otherwise: kernels.twins); the rest of the band cloud
optics is plain PyTorch. With one, the native engine (gas_optics.py,
rte_native.py) runs, plain PyTorch but for K8's draws and K9's LW cloud
rows on CUDA tensors.

Cloud optics: the band-resolved properties come from the RRTMG scheme's
Ebert-Curry/Key/Fu + Hu-Stamnes parameterizations (the RRTMGSW / RRTMGLW
modules' tables), evaluated once per band and expanded to g-points by
sampling.draw_samples.

The reference jits rrtmgp_sw and rrtmgp_lw (:128, :253): here their
bodies are `rrtmgp_sw_eager` / `rrtmgp_lw_eager` and `rrtmgp_sw` /
`rrtmgp_lw` those bodies as captured entries (driver/compiled.py), one
CUDA graph per static key on a card.
"""

from functools import lru_cache

import numpy as np
import torch

from ...driver.compiled import captured, with_kernels
from ...kernels.twins import twins, use_kernel
from ...ops import mcica_gmr_cuda, threefry
from ...ops.mcica import (_sigma_class, column_blocks, overlap_params,
                          state_seed_key, zcw_lookup_class)
from ...tables import on_device
from ..rrtmg.cldprmc_lw import band_abs_coeffs_lw
from ..rrtmg.cldprmc_sw import (band_optics_coeffs_sw,
                                cldprmc_from_band_coeffs_sw)
from ..rrtmg.lw import level_temperatures
from ..rrtmg.sw import _UVBAND
from .gas_concs import GasConcs
from .kdist import KDistLW, KDistLWNative, KDistSW, KDistSWNative
from .rte import rte_lw
from .rte_sw_cuda import rte_sw_fast
from .rte_native import rte_lw_native, rte_sw_native
from .sampling import draw_samples, sampled_urand_gen_max_ran

# bytes of one int64 plane of a column block's threefry draws: the
# generator's few int64 temporaries then hold ~2 GB at a time
_DRAW_BLOCK_BYTES = 1 << 29


@lru_cache(maxsize=8)
def _kdist_lw_native(path, device):
    """Load-once cache of an ingested LW coefficient set on device (the
    reference's load_and_init at GC initialize,
    GEOS_IrradGridComp.F90:2151+)."""
    return KDistLWNative(path, device)


@lru_cache(maxsize=8)
def _kdist_sw_native(path, device):
    return KDistSWNative(path, device)


def _band_remap(native_wvn, host_wvn):
    """Map each native band to the host (RRTMG) band containing its
    center wavenumber (nearest interval if outside). Used to evaluate
    the band cloud-optics parameterizations at the native band centers."""
    mid = 0.5 * (np.asarray(native_wvn[:, 0], np.float64)
                 + np.asarray(native_wvn[:, 1]))
    lo = np.asarray(host_wvn[:, 0], np.float64)
    hi = np.asarray(host_wvn[:, 1], np.float64)
    idx = np.zeros(mid.size, np.int64)
    for b, m in enumerate(mid):
        inside = np.nonzero((m >= lo) & (m < hi))[0]
        if inside.size:
            idx[b] = inside[0]
        else:
            idx[b] = np.argmin(np.minimum(np.abs(m - lo),
                                          np.abs(m - hi)))
    return idx


def _band_cloud_optics_sw(ciwp, clwp, rei, rel, tables, iceflag, liqflag):
    """Band-resolved SW cloud optical properties for fully-cloudy cells:
    the per-g-point parameterization (band-constant coefficients)
    evaluated at one point per band. Returns (tau, ssa, g), each
    [ncol, nlay, 14]."""
    ncol, nlay = ciwp.shape
    coeffs = band_optics_coeffs_sw(rei, rel, tables, iceflag=iceflag,
                                   liqflag=liqflag)
    nbnd = coeffs[0].shape[-1]
    ones = torch.ones((ncol, nbnd, nlay), dtype=torch.bool,
                      device=ciwp.device)

    def bc(x):
        return x[:, None, :].expand(ncol, nbnd, nlay)
    tau, ssa, asm, _ = cldprmc_from_band_coeffs_sw(
        ones, bc(ciwp), bc(clwp), coeffs, band_g=np.arange(nbnd))
    return tuple(x.transpose(1, 2) for x in (tau, ssa, asm))


def _band_cloud_optics_lw(ciwp, clwp, rei, rel, tables, iceflag, liqflag):
    """Band-resolved LW cloud absorption optical depth for fully-cloudy
    cells, [ncol, nlay, 16] (cldprmc_lw at one g-point per band); the
    cloud rows through kernel K9 (band_abs_coeffs_lw)."""
    absice, absliq = band_abs_coeffs_lw(rei, rel, tables, iceflag=iceflag,
                                        liqflag=liqflag)
    ci, cl = ciwp[..., None], clwp[..., None]
    zero = ciwp.new_zeros(())
    return (torch.where(ci > 0.0, ci * absice, zero)
            + torch.where(cl > 0.0, cl * absliq, zero))


def _gen_max_ran_mask(play, zm, alat, doy, cldf, ngpt, zcw_cols):
    """GEN_MAX_RAN_OVERLAP cloud mask + condensate scaling
    (GEOS_SolarGridComp.F90:5186-5299): exponential layer-pair
    correlations (Oreopoulos-2012 decorrelation lengths) for presence
    and condensate, generalized max-random urand chains, cld_frac
    threshold mask, zcw condensate scaling with sigma from cloud
    fraction.

    The four fields are one threefry draw of shape (4, ngpt, nlay) from
    each column's state key (default seed order, for SW and LW alike),
    drawn in column blocks to bound the int64 temporaries. zcw_cols: the
    (3, 1000) class columns of the condensate PDF, or None for none
    (inhm 0: zcw = 1). Returns cld_mask bool [ncol, nlay, ngpt] and zcw
    [ncol, nlay, ngpt] (zero where clear).

    Kernel K8 (ops/mcica_gmr_cuda.py) where kernels.twins.use_kernel,
    the same values bit for bit; otherwise the body below, K8's plain
    twin.
    """
    alpha, rcorr = overlap_params(zm, alat, doy)
    if use_kernel(cldf):
        return mcica_gmr_cuda.gen_max_ran_mask(
            play.contiguous(), alpha, rcorr, cldf.contiguous(), ngpt,
            zcw_cols)
    alpha, rcorr = alpha[:, 1:], rcorr[:, 1:]
    keys = state_seed_key(play)                      # [ncol, 2]
    ncol, nlay = play.shape
    sigcls = _sigma_class(cldf)[:, None, :]
    block = max(1, _DRAW_BLOCK_BYTES // (4 * ngpt * nlay * 8))
    masks, zcws = [], []
    for s in column_blocks(ncol, block):
        draws = threefry.uniform(keys[s], (4, ngpt, nlay))
        urand = sampled_urand_gen_max_ran(alpha[s], draws[:, 0],
                                          draws[:, 1])
        uc = sampled_urand_gen_max_ran(rcorr[s], draws[:, 2], draws[:, 3])
        del draws
        cld_mask = (urand < cldf[s, None, :]).transpose(1, 2) \
            & (cldf[s] > 0.0)[:, :, None]
        if zcw_cols is None:
            zcw = torch.ones_like(uc)
        else:
            zcw = zcw_lookup_class(uc, sigcls[s].expand_as(uc), zcw_cols)
        masks.append(cld_mask)
        zcws.append(torch.where(cld_mask, zcw.transpose(1, 2),
                                zcw.new_zeros(())))
    return torch.cat(masks), torch.cat(zcws)


def _zcw_cols(module, inhm):
    """The module's condensate class columns for inhm (None for 0)."""
    return None if inhm == 0 else module.zcw_cols(inhm)


def _gas_sw(h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr):
    return (GasConcs()
            .set_vmr("h2o", h2ovmr).set_vmr("o3", o3vmr)
            .set_vmr("co2", co2vmr).set_vmr("ch4", ch4vmr)
            .set_vmr("o2", o2vmr))


def _gas_lw(h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, cfc11vmr,
            cfc12vmr, cfc22vmr, ccl4vmr, covmr):
    return (GasConcs()
            .set_vmr("h2o", h2ovmr).set_vmr("o3", o3vmr)
            .set_vmr("co2", co2vmr).set_vmr("ch4", ch4vmr)
            .set_vmr("n2o", n2ovmr).set_vmr("o2", o2vmr)
            .set_vmr("cfc11", cfc11vmr).set_vmr("cfc12", cfc12vmr)
            .set_vmr("hcfc22", cfc22vmr).set_vmr("ccl4", ccl4vmr)
            .set_vmr("co", covmr))


def _sw_albedos(uvband, albdir_uv, albdif_uv, albdir_nir, albdif_nir):
    uv = on_device(uvband, albdir_uv.device)
    return (torch.where(uv, albdir_uv[:, None], albdir_nir[:, None]),
            torch.where(uv, albdif_uv[:, None], albdif_nir[:, None]))


def rrtmgp_sw_eager(sw, ple, play, tlay, coszen, albdir_uv, albdif_uv,
                    albdir_nir, albdif_nir,
                    h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
                    cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                    taua=None, ssaa=None, asya=None,
                    tsi_scale=None, mg=0.1567652, sb=909.7126, *,
                    iceflag=3, liqflag=1, inhm=1, kdist_path=None,
                    plain=False):
    """RRTMGP-path SW fluxes (all-sky + clear), mirroring rrtmg_sw's
    interface, run op by op. sw: the RRTMGSW holding the tables (the
    facade's k-distribution, and the cloud optics and condensate tables of
    both routes). mg/sb: NRLSSI2 indices (k_dist%set_solar_variability);
    tsi_scale: optional [ncol] factor applied to the solar source.

    kdist_path: when set, an ingested RRTMGP coefficient file
    (tools/rrtmgp_ingest.py npz) runs through the NATIVE interpolation
    engine + band-agnostic RTE; without it the RRTMG-reduced facade
    serves as the k-distribution (kernel K5). plain=True runs every
    kernel's plain twin (the body under kernels.twins.twins).

    Returns dict bbfu, bbfd, bbfddir, bbcu, bbcd [ncol, nlay+1] (W/m^2).
    """
    with twins(plain):
        if kdist_path is not None:
            return _rrtmgp_sw_native(
                _kdist_sw_native(kdist_path, str(tlay.device)), sw, ple, play,
                tlay, coszen, albdir_uv, albdif_uv, albdir_nir, albdif_nir,
                h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
                cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                taua, ssaa, asya, tsi_scale, iceflag, liqflag, inhm)
        kd = KDistSW(sw).set_solar_variability(mg, sb)
        gas = _gas_sw(h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr)
        taug, taur, toa_src = kd.gas_optics(play, tlay, ple * 0.01, gas)
        if tsi_scale is not None:
            toa_src = toa_src * tsi_scale[:, None]

        lims = kd.get_band_lims_gpoint()
        cld_mask, zcw = _gen_max_ran_mask(play, zm, alat, doy, cldf,
                                          kd.get_ngpt(), _zcw_cols(sw, inhm))
        tau_b, ssa_b, g_b = _band_cloud_optics_sw(
            ciwp, clwp, rei, rel, sw.cloud_tables, iceflag, liqflag)
        props = draw_samples(cld_mask, dict(tau=tau_b, ssa=ssa_b, g=g_b), lims)
        # condensate-inhomogeneity scaling of tau (GC :5293-5299)
        tau_cld = props["tau"] * zcw

        alb_dir, alb_dif = _sw_albedos(_UVBAND, albdir_uv, albdif_uv,
                                       albdir_nir, albdif_nir)
        aero = {k: None if x is None else x.contiguous() for k, x in
                (("tau_aer", taua), ("ssa_aer", ssaa), ("g_aer", asya))}
        allsky, clrsky = rte_sw_fast(taug, taur, tau_cld, props["ssa"],
                                     props["g"], toa_src.contiguous(),
                                     coszen.contiguous(), alb_dir, alb_dif,
                                     lims, **aero)
        day = (coszen > 0.0).to(taug.dtype)[:, None]
        return dict(bbfu=allsky["flux_up"] * day, bbfd=allsky["flux_dn"] * day,
                    bbfddir=allsky["flux_dir"] * day,
                    bbcu=clrsky["flux_up"] * day, bbcd=clrsky["flux_dn"] * day)


def _rrtmgp_sw_native(kd, sw, ple, play, tlay, coszen, albdir_uv,
                      albdif_uv, albdir_nir, albdif_nir,
                      h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
                      cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                      taua, ssaa, asya, tsi_scale, iceflag, liqflag,
                      inhm):
    """SW through the native engine: arbitrary band/g-point layout."""
    gas = _gas_sw(h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr)
    taug, taur, toa_src = kd.gas_optics(play, tlay, ple * 0.01, gas)
    if tsi_scale is not None:
        toa_src = toa_src * tsi_scale[:, None]

    lims = kd.get_band_lims_gpoint()
    cld_mask, zcw = _gen_max_ran_mask(play, zm, alat, doy, cldf,
                                      kd.get_ngpt(), _zcw_cols(sw, inhm))
    # RRTMG 14-band cloud parameterization sampled at the native bands
    host = KDistSW(sw)
    tau_h, ssa_h, g_h = _band_cloud_optics_sw(
        ciwp, clwp, rei, rel, sw.cloud_tables, iceflag, liqflag)
    remap = on_device(_band_remap(kd.get_band_lims_wavenumber(),
                                  host.get_band_lims_wavenumber()),
                      tlay.device)
    props = draw_samples(cld_mask, dict(tau=tau_h[..., remap],
                                        ssa=ssa_h[..., remap],
                                        g=g_h[..., remap]), lims)
    tau_cld = props["tau"] * zcw

    # UV/vis vs NIR surface albedo split by band center (RRTMG's
    # ibm 10-13 == 12850-50000 cm-1)
    wvn = kd.get_band_lims_wavenumber()
    alb_dir, alb_dif = _sw_albedos(0.5 * (wvn[:, 0] + wvn[:, 1]) >= 12850.0,
                                   albdir_uv, albdif_uv, albdir_nir,
                                   albdif_nir)

    # aerosol optics arrive on the RRTMG 14-band grid; sampled at the
    # native band centers like the cloud parameterization
    def rm(x):
        return None if x is None else x[..., remap]
    out = rte_sw_native(taug, taur, toa_src, coszen, alb_dir, alb_dif,
                        lims, tau_cld=tau_cld, ssa_cld=props["ssa"],
                        g_cld=props["g"], tau_aer=rm(taua),
                        ssa_aer=rm(ssaa), g_aer=rm(asya))
    return dict(bbfu=out["flux_up"], bbfd=out["flux_dn"],
                bbfddir=out["flux_dir"],
                bbcu=out["flux_up_clr"], bbcd=out["flux_dn_clr"])


def rrtmgp_lw_eager(lw, ple, play, tlay, tsfc, emis,
                    h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr,
                    cfc11vmr, cfc12vmr, cfc22vmr,
                    cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                    ccl4vmr=0.0, covmr=0.0,
                    *, iceflag=3, liqflag=1, inhm=1, dudts=True,
                    kdist_path=None, plain=False):
    """RRTMGP-path LW fluxes (all-sky + clear) with McICA clouds, run op
    by op. lw: the
    RRTMGLW holding the tables (the facade's k-distribution, and the
    cloud optics and condensate tables of both routes); emis [ncol, 16].

    kdist_path: when set, routes an ingested RRTMGP coefficient set
    (tools/rrtmgp_ingest.py npz) through the NATIVE engine +
    band-agnostic RTE; otherwise the RRTMG-reduced facade (kernels K3
    and K4). plain=True runs every kernel's plain twin (the body under
    kernels.twins.twins).

    Returns dict flux_up, flux_dn, flux_up_clr, flux_dn_clr
    [ncol, nlay+1], olrb [ncol, nbnd] (+ duflx_dts, duflxc_dts,
    dolrb_dts when dudts).
    """
    with twins(plain):
        gas = _gas_lw(h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, cfc11vmr,
                      cfc12vmr, cfc22vmr, ccl4vmr, covmr)
        plev = ple * 0.01
        tlev = level_temperatures(play, tlay, plev, tsfc)
        if kdist_path is not None:
            return _rrtmgp_lw_native(
                _kdist_lw_native(kdist_path, str(tlay.device)), lw, play, tlay,
                plev, tlev, tsfc, emis, gas, cldf, ciwp, clwp, rei, rel, zm,
                alat, doy, iceflag, liqflag, inhm, dudts)
        kd = KDistLW(lw)
        taug, sources = kd.gas_optics(play, tlay, plev, tlev, tsfc, emis, gas,
                                      dudts=dudts)

        lims = kd.get_band_lims_gpoint()
        cld_mask, zcw = _gen_max_ran_mask(play, zm, alat, doy, cldf,
                                          kd.get_ngpt(), _zcw_cols(lw, inhm))
        tau_b = _band_cloud_optics_lw(ciwp, clwp, rei, rel, lw.cloud_tables,
                                      iceflag, liqflag)
        tau_cld = draw_samples(cld_mask, dict(tau=tau_b), lims)["tau"] * zcw
        return rte_lw(taug, sources, emis, tau_cld=tau_cld,
                      cld_mask=cld_mask.any(dim=-1), dudts=dudts)


def _rrtmgp_lw_native(kd, lw, play, tlay, plev, tlev, tsfc, emis, gas,
                      cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                      iceflag, liqflag, inhm, dudts):
    """LW through the native engine with McICA clouds."""
    taug, sources = kd.gas_optics(play, tlay, plev, tlev, tsfc, emis, gas)

    lims = kd.get_band_lims_gpoint()
    nbnd = kd.get_nband()
    cld_mask, zcw = _gen_max_ran_mask(play, zm, alat, doy, cldf,
                                      kd.get_ngpt(), _zcw_cols(lw, inhm))
    host = KDistLW(lw)
    tau_h = _band_cloud_optics_lw(ciwp, clwp, rei, rel, lw.cloud_tables,
                                  iceflag, liqflag)
    remap = on_device(_band_remap(kd.get_band_lims_wavenumber(),
                                  host.get_band_lims_wavenumber()),
                      tlay.device)
    tau_cld = draw_samples(cld_mask, dict(tau=tau_h[..., remap]),
                           lims)["tau"] * zcw

    ncol = tlay.shape[0]
    emis_b = (emis[:, :1] if emis.ndim == 2 else emis[:, None]).expand(
        ncol, nbnd)
    out = rte_lw_native(taug, sources, emis_b, lims, tau_cld=tau_cld,
                        dudts=dudts)
    res = dict(flux_up=out["uflx"], flux_dn=out["dflx"],
               flux_up_clr=out["uflxc"], flux_dn_clr=out["dflxc"],
               olrb=out["olrb"])
    if dudts:
        res.update(duflx_dts=out["duflx_dts"],
                   duflxc_dts=out["duflxc_dts"],
                   dolrb_dts=out["dolrb_dts"])
    return res


rrtmgp_sw = captured(
    rrtmgp_sw_eager,
    static_argnames=("sw", "mg", "sb", "iceflag", "liqflag", "inhm",
                     "kdist_path", "plain"),
    route=with_kernels)
rrtmgp_sw.__doc__ = """RRTMGP-path SW fluxes (rrtmgp_sw_eager's arguments
and results), as a CUDA graph captured once per static key on a card:
the reference's static argnames (models/rrtmgp/scheme.py:128), the
table module sw (by identity), plain, and mg and sb. Unlike the
reference, where mg and sb are traced, they are static here (their
values in the key): set_solar_variability folds them into
the solar-source weights on the host, which a traced value would have to
be read back for; the driver always passes the defaults. doy, tsi_scale
and the tensors are traced. CPU tensors and plain=True run the body
eagerly."""

rrtmgp_lw = captured(
    rrtmgp_lw_eager,
    static_argnames=("lw", "iceflag", "liqflag", "inhm", "dudts",
                     "kdist_path", "plain"),
    route=with_kernels)
rrtmgp_lw.__doc__ = """RRTMGP-path LW fluxes (rrtmgp_lw_eager's arguments
and results), as a CUDA graph captured once per static key on a card:
the reference's static argnames (models/rrtmgp/scheme.py:253), the
table module lw (by identity) and plain; doy, ccl4vmr, covmr and the
tensors are traced. CPU tensors and plain=True run the body eagerly."""
