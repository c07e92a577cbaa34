#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 McICA + LW cloud optics, K2 McICA + SW
cloud optics, K3 taumol-LW, K4 rtrnmc, K5 taumol-SW, K6 spcvmc, K7 raw
McICA draws, P1 forward fill, P2 table gathers, P3 taumol-LW bisection)
from geosradiation_gridcomp_tpu_torch/csrc with nvcc for sm_90a, one
nvcc per source side by side, then:

1. kernel phases at 1024 columns x 72 levels: each kernel against its
   plain PyTorch twin on the same inputs on the card (K1, K2: cloudy masks
   and clear counts identical, cloud optics relmax <= 1e-5; K3, K5 relmax
   <= 5e-4 in every band; K4, K6 relmax <= 5e-4 for every output), with
   both times;
2. step phase at 8192 columns x 72 levels (the reference benchmark's
   workload, bench.py:190-228): radiation_refresh + radiation_update
   through their entry points on the realistic multi-deck scene, doy 172,
   12 UTC, with sw_partition_bounds daylight packing; every kernel K1-K6
   must launch; every IrradState field and LW export must agree with the
   plain path on the same card to relmax <= 5e-5, every SolarState field
   and SW export to relmax <= 5e-4 with at most 0.5 % of columns beyond
   5e-5 (tools/verify_tpu.py:279-281); fluxes must be physical; the wall
   time of the refresh with the kernels and with the plain twins;
3. kernel phases of the verification and profiling kernels, each against
   its plain twin on the same inputs, with both times: K7 at 1024 x 72
   and P1 on [1024, 72, 140] exactly equal; P2's gather_rows and
   gather_lanes at the profiling tool's 8192 x 72 points exactly equal;
   P3's full variant equal to K3 bit for bit and every variant within
   relmax 5e-4 of its twin in every band, at 1024 x 72;
4. verify path: the verification suite's entry point
   (tools/verify.py --quick, 512 x 72), every gate passing; K7 must
   launch there;
5. profiling path: the three profiling entry points (fused_mcica_check
   at 1024 columns, gather_micro at its default size, taumol_lw_bisect
   at 1024 x 72), each raising on a failed check; P1, both P2 kernels and
   P3 must launch there.

    python3 chip_smoke.py --profile

adds, after the step phase, where the time of the full-width refresh
goes: its wall time over 30 runs, the device time of each CUDA kernel,
the launches per refresh and the device's idle share (torch.profiler),
and the solar_refresh, irrad_refresh and subcolumn_keys stages alone
(CUDA events).

Prints the card's name and power limit, a JSON line with each kernel's
launches (counted on the path named by its `path`: step, verify or
profiling), error and times, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).
relmax is max|a - b| / max|b|, as the reference's tools/verify_tpu.py.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

NCOL_KERNEL = 1024
NCOL_SLICE = 8192
NLEV = 72
SEED = 0
DOY = 172.0
UTC = 12.0


def relmax(a, b, floor=1e-6):
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


def band_relmax(a, b, ngs):
    """Largest relmax over the bands' g-point slices; ngs: band starts."""
    return max(relmax(a[..., ngs[i]:ngs[i + 1]], b[..., ngs[i]:ngs[i + 1]])
               for i in range(len(ngs) - 1))


def flipped_share(a, b, limit=5e-5):
    """Share of columns whose largest error exceeds limit times max|b|."""
    err = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    scale = max(float(b.double().abs().max()), 1e-6)
    return float((err.max(dim=1).values / scale > limit).double().mean())


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def gate(name, value, limit):
    ok = value <= limit
    print(f"  {name:36s} {value:.3e} <= {limit:.0e}  "
          f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {value:.3e} > {limit:.0e}")


def time_ms(torch, fn, n):
    """Mean device time of fn over n runs (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_phases(torch, dev):
    """Each kernel against its plain twin at NCOL_KERNEL x NLEV."""
    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import \
        band_abs_coeffs_lw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc_cuda import \
        rtrnmc_fast
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
        setcoef_lw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import \
        taumol_lw_fast
    from geosradiation_gridcomp_tpu_torch.ops import mcica
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_optics_lw, mcica_optics_lw_plain)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    ncol = NCOL_KERNEL
    inp = example_inputs(ncol, NLEV, seed=SEED, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    absi, absl = band_abs_coeffs_lw(inp.ri, inp.rl, lw.cloud_tables)
    k1_args = (mcica.subcolumn_keys(play), alpha, rcorr, inp.fcld, ciwp,
               clwp, mcica._sigma_class(inp.fcld), absi.contiguous(),
               absl.contiguous(), lw.zcw_cols(1))
    k1_kw = dict(cloud_mh=28, cloud_lm=47, inhm=1)
    results = {}

    print(f"K1 mcica_optics_lw at {ncol} x {NLEV}:")
    tau_k, cld_k, cnt_k = mcica_optics_lw(*k1_args, **k1_kw)
    tau_p, cld_p, cnt_p = mcica_optics_lw_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    gate("cloudy mask mismatches", float((cld_k != cld_p).sum()), 0)
    gate("clear count mismatches", float((cnt_k != cnt_p).sum()), 0)
    gate("taucmc relmax", relmax(tau_k, tau_p), 1e-5)
    results["mcica_optics_lw"] = dict(
        max_abs_err=max_abs(tau_k, tau_p),
        ms=time_ms(torch, lambda: mcica_optics_lw(*k1_args, **k1_kw), 20),
        plain_ms=time_ms(torch, lambda: mcica_optics_lw_plain(
            *k1_args, **k1_kw), 3))

    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(ncol, 16).contiguous()
    z = torch.zeros_like(inp.co2)
    coefs = setcoef_lw(play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis,
                       h2o, o3, inp.co2, inp.ch4, inp.n2o,
                       torch.full_like(z, 0.2095), z, inp.cfc11, inp.cfc12,
                       inp.hcfc22, z, lw.planck_tables)
    tabs = lw.taumol_tables
    print(f"K3 taumol_lw at {ncol} x {NLEV}:")
    tg_k, pf_k = taumol_lw_fast(coefs, tabs)
    tg_p, pf_p = taumol_lw(coefs, tabs)
    gate("taug relmax, worst band", band_relmax(tg_k, tg_p, NGS_LW), 5e-4)
    gate("pfracs relmax, worst band", band_relmax(pf_k, pf_p, NGS_LW), 5e-4)
    gen = torch.Generator(dev).manual_seed(SEED)
    taua = 0.02 * torch.rand(ncol, NLEV, 16, device=dev, generator=gen)
    gate("taug relmax with taua, worst band",
         band_relmax(taumol_lw_fast(coefs, tabs, taua)[0],
                     taumol_lw(coefs, tabs, taua)[0], NGS_LW), 5e-4)
    results["taumol_lw"] = dict(
        max_abs_err=max(max_abs(tg_k, tg_p), max_abs(pf_k, pf_p)),
        ms=time_ms(torch, lambda: taumol_lw_fast(coefs, tabs), 20),
        plain_ms=time_ms(torch, lambda: taumol_lw(coefs, tabs), 3))

    print(f"K4 rtrnmc at {ncol} x {NLEV}:")
    k4_args = (emis, tg_p, pf_p, cld_p, tau_p, coefs.planklay,
               coefs.planklev, coefs.plankbnd, coefs.dplankbnd_dts,
               coefs.pwvcm)
    out_k = rtrnmc_fast(*k4_args)
    out_p = rtrnmc(*k4_args)
    for k in out_p:
        gate(f"{k} relmax", relmax(out_k[k], out_p[k]), 5e-4)
    results["rtrnmc"] = dict(
        max_abs_err=max(max_abs(out_k[k], out_p[k]) for k in out_p),
        ms=time_ms(torch, lambda: rtrnmc_fast(*k4_args), 20),
        plain_ms=time_ms(torch, lambda: rtrnmc(*k4_args), 3))
    results.update(sw_kernel_phases(torch, dev, inp, play, h2o, o3, zm,
                                    alpha, rcorr, ciwp, clwp))
    return results


def sw_kernel_phases(torch, dev, inp, play, h2o, o3, zm, alpha, rcorr, ciwp,
                     clwp):
    """K2, K5 and K6 against their plain twins at NCOL_KERNEL x NLEV."""
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import \
        band_optics_coeffs_sw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_sw import \
        setcoef_sw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import \
        spcvmc_sw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc_cuda import \
        spcvmc_fast
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
        NGS_SW, sfluxzen_only, taumol_sw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw_cuda import \
        taumol_sw_fast
    from geosradiation_gridcomp_tpu_torch.ops import mcica
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_optics_sw, mcica_optics_sw_plain)

    ncol = NCOL_KERNEL
    sw = swm.RRTMGSW.from_reference_tables(dev)
    results = {}
    coeffs = torch.stack(band_optics_coeffs_sw(inp.ri, inp.rl,
                                               sw.cloud_tables)).contiguous()
    k2_args = (mcica.subcolumn_keys(play, swm.SEED_ORDER_SW), alpha, rcorr,
               inp.fcld, ciwp, clwp, mcica._sigma_class(inp.fcld), coeffs,
               sw.zcw_cols(1))
    k2_kw = dict(cloud_mh=28, cloud_lm=47, inhm=1)
    print(f"K2 mcica_optics_sw at {ncol} x {NLEV}:")
    out_k = mcica_optics_sw(*k2_args, **k2_kw)
    out_p = mcica_optics_sw_plain(*k2_args, **k2_kw)
    torch.cuda.synchronize()
    gate("cloudy mask mismatches", float((out_k[3] != out_p[3]).sum()), 0)
    gate("clear count mismatches", float((out_k[4] != out_p[4]).sum()), 0)
    for name, a, b in zip(("taucmc", "ssacmc", "asmcmc"), out_k, out_p):
        gate(f"{name} relmax", relmax(a, b), 1e-5)
    results["mcica_optics_sw"] = dict(
        max_abs_err=max(max_abs(a, b) for a, b in zip(out_k[:3], out_p[:3])),
        ms=time_ms(torch, lambda: mcica_optics_sw(*k2_args, **k2_kw), 20),
        plain_ms=time_ms(torch, lambda: mcica_optics_sw_plain(
            *k2_args, **k2_kw), 3))

    coefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                       inp.ch4, torch.full_like(play, 0.2095),
                       sw.reference_tables)
    tabs = sw.taumol_tables
    print(f"K5 taumol_sw at {ncol} x {NLEV}:")
    tg_k, tr_k = taumol_sw_fast(coefs, tabs)
    tg_p, tr_p = taumol_sw(coefs, tabs)
    gate("taug relmax, worst band", band_relmax(tg_k, tg_p, NGS_SW), 5e-4)
    gate("taur relmax, worst band", band_relmax(tr_k, tr_p, NGS_SW), 5e-4)
    results["taumol_sw"] = dict(
        max_abs_err=max(max_abs(tg_k, tg_p), max_abs(tr_k, tr_p)),
        ms=time_ms(torch, lambda: taumol_sw_fast(coefs, tabs), 20),
        plain_ms=time_ms(torch, lambda: taumol_sw(coefs, tabs), 3))

    print(f"K6 spcvmc at {ncol} x {NLEV}:")
    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC, 1.0)
    mu0 = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                      torch.zeros_like(slr))
    sflux = sfluxzen_only(coefs, sw.solar_sources(
        swm.solar_source_weights(-1, 1361.0)))
    alb = torch.stack([inp.albnr] * 9 + [inp.albvr] * 4 + [inp.albnr],
                      dim=1).contiguous()
    albf = torch.stack([inp.albnf] * 9 + [inp.albvf] * 4 + [inp.albnf],
                       dim=1).contiguous()
    k6_args = (coefs, tg_p, tr_p, sflux, mu0, alb, albf, out_p[3],
               *out_p[:3])
    gen = torch.Generator(dev).manual_seed(SEED)
    rnd = lambda lo, hi: lo + (hi - lo) * torch.rand(
        ncol, NLEV, 14, device=dev, generator=gen)
    aero = dict(taua=rnd(0.0, 0.1), ssaa=rnd(0.8, 1.0), asya=rnd(0.5, 0.8))
    err = 0.0
    for label, kw in (("", {}), (" with aerosol", aero),
                      (" with ncld 512", dict(ncld=512))):
        a = spcvmc_fast(*k6_args, **kw)
        b = spcvmc_sw(*k6_args, **kw)
        gate(f"worst output relmax{label}",
             max(relmax(a[k], b[k]) for k in b), 5e-4)
        err = max(err, max(max_abs(a[k], b[k]) for k in b))
    results["spcvmc"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: spcvmc_fast(*k6_args), 20),
        plain_ms=time_ms(torch, lambda: spcvmc_sw(*k6_args), 3))
    return results


def raw_and_profiling_kernel_phases(torch, dev):
    """K7, P1, P2 and P3 against their plain twins: K7, P1 and P3 at
    NCOL_KERNEL x NLEV, P2 at the profiling tool's size."""
    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, VARIANTS, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import (
        taumol_lw_bisect, taumol_lw_fast)
    from geosradiation_gridcomp_tpu_torch.ops import mcica
    from geosradiation_gridcomp_tpu_torch.ops.ffill_cuda import (ffill,
                                                                 ffill_plain)
    from geosradiation_gridcomp_tpu_torch.ops.gather_cuda import (
        gather_lanes, gather_lanes_plain, gather_rows, gather_rows_plain)
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_subcols_raw, mcica_subcols_raw_plain)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs
    from geosradiation_gridcomp_tpu_torch.tools.profiling.taumol_lw_bisect \
        import lw_coefs

    ncol = NCOL_KERNEL
    results = {}

    def exact(name, a, b):
        gate(f"{name} mismatches", float((a != b).sum()), 0)
        return max_abs(a, b)

    inp = example_inputs(ncol, NLEV, seed=SEED, device=dev)
    play = rad._common_derived(inp)[0]
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    k7_args = (mcica.subcolumn_keys(play), alpha, rcorr, inp.fcld)
    print(f"K7 mcica_subcols_raw at {ncol} x {NLEV}:")
    a = mcica_subcols_raw(*k7_args, nsub=140)
    b = mcica_subcols_raw_plain(*k7_args, nsub=140)
    results["mcica_subcols_raw"] = dict(
        max_abs_err=max(exact("cloudy", a[0], b[0]), exact("v3", a[1], b[1])),
        ms=time_ms(torch, lambda: mcica_subcols_raw(*k7_args, nsub=140), 20),
        plain_ms=time_ms(torch, lambda: mcica_subcols_raw_plain(
            *k7_args, nsub=140), 3))

    gen = torch.Generator(dev).manual_seed(SEED)
    v = torch.rand(ncol, NLEV, 140, device=dev, generator=gen)
    keep = (torch.rand(ncol, NLEV, 140, device=dev, generator=gen)
            > 0.6).float()
    print(f"P1 ffill on [{ncol}, {NLEV}, 140]:")
    results["ffill"] = dict(
        max_abs_err=exact("ffill", ffill(v, keep), ffill_plain(v, keep)),
        ms=time_ms(torch, lambda: ffill(v, keep), 20),
        plain_ms=time_ms(torch, lambda: ffill_plain(v, keep), 3))

    n, rows = 8192 * NLEV, 585
    tab = torch.randn(rows, 16, device=dev, generator=gen)
    tabt = torch.nn.functional.pad(tab.T, (0, 640 - rows)).contiguous()
    idx = torch.randint(0, rows, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    idx2d = idx.reshape(-1, 128)
    print(f"P2 gather_rows, gather_lanes at {n} points, {rows} x 16 table:")
    results["gather_rows"] = dict(
        max_abs_err=exact("gather_rows", gather_rows(idx, tab),
                          gather_rows_plain(idx, tab)),
        ms=time_ms(torch, lambda: gather_rows(idx, tab), 20),
        plain_ms=time_ms(torch, lambda: gather_rows_plain(idx, tab), 20))
    results["gather_lanes"] = dict(
        max_abs_err=exact("gather_lanes", gather_lanes(idx2d, tabt),
                          gather_lanes_plain(idx2d, tabt)),
        ms=time_ms(torch, lambda: gather_lanes(idx2d, tabt), 20),
        plain_ms=time_ms(torch, lambda: gather_lanes_plain(idx2d, tabt),
                         20))

    coefs, tabs = lw_coefs(dev, ncol)
    print(f"P3 taumol_lw_bisect at {ncol} x {NLEV}:")
    k3 = taumol_lw_fast(coefs, tabs)
    full = taumol_lw_bisect(coefs, tabs, VARIANTS["full"])
    for name, x, y in zip(("taug", "pfracs"), full, k3):
        exact(f"full vs K3 {name}", x, y)
    err = 0.0
    for name, parts in VARIANTS.items():
        tg_k, pf_k = taumol_lw_bisect(coefs, tabs, parts)
        tg_p, pf_p = taumol_lw(coefs, tabs, parts=parts)
        gate(f"{name} taug relmax, worst band",
             band_relmax(tg_k, tg_p, NGS_LW), 5e-4)
        gate(f"{name} pfracs relmax, worst band",
             band_relmax(pf_k, pf_p, NGS_LW), 5e-4)
        err = max(err, max_abs(tg_k, tg_p), max_abs(pf_k, pf_p))
        ms = time_ms(torch, lambda: taumol_lw_bisect(coefs, tabs, parts), 20)
        print(f"  {name}: {ms:.4f} ms")
    results["taumol_lw_bisect"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: taumol_lw_bisect(coefs, tabs,
                                                   VARIANTS["full"]), 20),
        plain_ms=time_ms(torch, lambda: taumol_lw(coefs, tabs), 3))
    return results


def verify_path(torch):
    """The verification suite through its entry point, at --quick size;
    returns the launches it made."""
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.tools import verify

    print("verify: python -m geosradiation_gridcomp_tpu_torch.tools.verify "
          "--quick")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    verify.main(["--quick"])
    torch.cuda.synchronize()
    return dict(LAUNCHES)


def profiling_path(torch):
    """The three profiling entry points; returns the launches they made."""
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.tools.profiling import (
        fused_mcica_check, gather_micro, taumol_lw_bisect)

    print("profiling: fused_mcica_check --ncol 1024, gather_micro, "
          "taumol_lw_bisect --ncol 1024")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    fused_mcica_check.main(["--ncol", str(NCOL_KERNEL)])
    gather_micro.main([])
    taumol_lw_bisect.main(["--ncol", str(NCOL_KERNEL)])
    torch.cuda.synchronize()
    return dict(LAUNCHES)


def step_phase(torch, dev):
    """radiation_refresh + radiation_update at full width through their
    entry points, as bench.py drives the reference."""
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    ncol = NCOL_SLICE
    inp = example_inputs(ncol, NLEV, seed=SEED, device=dev)
    cfg = RadiationConfig()
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    # bench.py's bounds: the larger over the benchmark's doy range
    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, UTC, cfg)
              for d in (DOY, DOY + 0.01)]
    nlit = None if any(b[0] is None for b in bounds) \
        else max(b[0] for b in bounds)
    ncld = None if any(b[1] is None for b in bounds) \
        else max(b[1] for b in bounds)
    mods = dict(sw=RRTMGSW.from_reference_tables(dev),
                lw=RRTMGLW.from_reference_tables(dev))

    def refresh(plain):
        return radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict, icb=icb,
                                 sw_nlit=nlit, sw_ncld=ncld, plain=plain,
                                 **mods)

    def run(plain):
        sol, irr = refresh(plain)
        upd = radiation_update(sol, irr, inp.tsinst + 0.5, inp.lons,
                               inp.lats, inp.ple, DOY, UTC + 0.25, config=cfg)
        return sol, irr, upd

    print(f"step: radiation_refresh + radiation_update at {ncol} x {NLEV}, "
          f"ict={ict} icb={icb}, sw_nlit={nlit} sw_ncld={ncld}:")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    sol, irr, upd = run(plain=False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the main path: {launches}")
    require_launched(launches, "step")
    sol_p, irr_p, upd_p = run(plain=True)
    for f in irr._fields:
        gate(f"IrradState.{f} relmax", relmax(getattr(irr, f),
                                              getattr(irr_p, f)), 5e-5)
    for k in upd["lw"]:
        gate(f"lw export {k} relmax", relmax(upd["lw"][k], upd_p["lw"][k]),
             5e-5)
    for k in ("alw", "blw"):
        gate(f"{k} relmax", relmax(upd[k], upd_p[k]), 5e-5)
    flips = []
    for name, a, b in [*[(f"SolarState.{f}", getattr(sol, f),
                          getattr(sol_p, f)) for f in sol._fields],
                       *[(f"sw export {k}", upd["sw"][k], upd_p["sw"][k])
                         for k in upd["sw"]]]:
        gate(f"{name} relmax", relmax(a, b), 5e-4)
        flips.append((flipped_share(a, b), name))
    worst = max(flips)
    gate(f"flipped column share, worst ({worst[1]})", worst[0], 5e-3)
    # heating rates divide flux differences by the layer's dp, which is a
    # few Pa near the model top: reported, not gated
    dtdt, dtdt_p = upd["dtdt"], upd_p["dtdt"]
    play = 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    low = play > 1.0e4
    print(f"  heating_rates relmax {relmax(dtdt, dtdt_p):.3e}, below "
          f"100 hPa {relmax(dtdt[low], dtdt_p[low]):.3e} (reported)")

    for name, x in [*zip(sol._fields, sol), *zip(irr._fields, irr),
                    *upd["sw"].items(), *upd["lw"].items(), ("dtdt", dtdt)]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} has non-finite values")
    if sol.flxn.shape != (ncol, NLEV + 1) or irr.olrb.shape != (ncol, 16) \
            or sol.flx_sfc_band_n.shape != (ncol, 14):
        raise AssertionError("state shapes are wrong")
    # net SW (normalized by the TOA insolation) never exceeds it
    net_max = float(sol.flxn.max())
    print(f"  SW net / TOA insolation: max {net_max:.4f}, surface min "
          f"{float(sol.flxn[:, -1].min()):.4f}")
    if not (net_max <= 1.0 + 1e-6 and float(sol.flxn[:, -1].min()) >= 0.0):
        raise AssertionError("SW net flux beyond the TOA insolation")
    olr = upd["lw"]["olr"]
    print(f"  OLR min/mean/max {float(olr.min()):.1f} / "
          f"{float(olr.mean()):.1f} / {float(olr.max()):.1f} W/m^2")
    if not (float(olr.min()) > 150.0 and float(olr.max()) < 350.0):
        raise AssertionError("OLR outside 150-350 W/m^2")
    hr = (dtdt * 86400.0)[low]
    print(f"  |SW+LW heating| below 100 hPa: max "
          f"{float(hr.abs().max()):.2f} K/day")
    if not float(hr.abs().max()) < 50.0:
        raise AssertionError("heating rate beyond 50 K/day")

    def wall(plain, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refresh(plain)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    # plain, kernel, kernel, plain: compare within one call
    torch.cuda.reset_peak_memory_stats()
    t_plain = [wall(True)]
    t_kern = [wall(False), wall(False)]
    t_plain.append(wall(True))
    tk, tp = min(t_kern), min(t_plain)
    print(f"  radiation_refresh wall time (median of 5, better of 2 rounds):"
          f" kernels {tk * 1e3:.2f} ms ({ncol / tk:.0f} columns/s), plain "
          f"{tp * 1e3:.2f} ms ({ncol / tp:.0f} columns/s); rounds "
          f"{t_kern} / {t_plain}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, dict(inp=inp, cfg=cfg, ict=ict, icb=icb, nlit=nlit,
                          ncld=ncld, mods=mods, refresh=refresh)


def profile_phase(torch, step, nwall=30, nprof=5):
    """--profile: where the time of the full-width refresh goes."""
    from torch.profiler import ProfilerActivity, profile

    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import \
        SEED_ORDER_SW
    from geosradiation_gridcomp_tpu_torch.ops import mcica

    refresh = step["refresh"]
    inp, cfg, nlit = step["inp"], step["cfg"], step["nlit"]
    print(f"profile: radiation_refresh at {NCOL_SLICE} x {NLEV}:")
    times = []
    for _ in range(nwall):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh(False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    q = statistics.quantiles(times, n=4)
    print(f"  wall over {nwall}: median {statistics.median(times) * 1e3:.3f}"
          f" ms, quartiles {q[0] * 1e3:.3f} / {q[2] * 1e3:.3f}, min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nprof):
            refresh(False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / nprof

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if on_device(e) and e.device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3 / nprof
    print(f"  under the profiler: {wall * 1e3:.3f} ms per refresh, device "
          f"kernel time {total:.3f} ms in "
          f"{sum(r[1] for r in rows) / nprof:.0f} launches")
    for dt, count, key in rows[:25]:
        print(f"  {dt / 1e3 / nprof:8.3f} ms {count / nprof:7.1f}x  "
              f"{key[:100]}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if on_device(e) and e.time_range.elapsed_us() > 0)
    busy, cur = 0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0 if cur is None else cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0
    print(f"  device busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms profiled "
          f"({100.0 * (1.0 - busy / max(span, 1)):.1f} % idle under the "
          f"profiler)")

    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC,
                               cfg.solar_dt / 3600.0)
    zth = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                      torch.zeros_like(slr))
    play = rad._common_derived(inp)[0]
    stages = dict(
        solar_refresh=lambda: rad.solar_refresh(
            inp, zth, DOY, cfg, step["ict"], step["icb"], nlit=nlit,
            ncld=step["ncld"], sw=step["mods"]["sw"]),
        irrad_refresh=lambda: rad.irrad_refresh(
            inp, DOY, cfg, step["ict"], step["icb"], lw=step["mods"]["lw"]),
        subcolumn_keys_lw=lambda: mcica.subcolumn_keys(play),
        subcolumn_keys_sw=lambda: mcica.subcolumn_keys(
            play[:nlit], SEED_ORDER_SW))
    for name, fn in stages.items():
        print(f"  {name} alone: {time_ms(torch, fn, 10):.3f} ms (CUDA "
              f"events, mean of 10)")


_CSRC = "geosradiation_gridcomp_tpu_torch/csrc/"
_REF = "geosradiation_gridcomp_tpu/"
# kernel -> (source, the TPU kernel it replaces, the path that must launch
# it: step, verify or profiling)
SOURCES = {
    "mcica_optics_lw": (_CSRC + "mcica_lw.cu",
                        _REF + "ops/mcica_pallas.py:367", "step"),
    "mcica_optics_sw": (_CSRC + "mcica_sw.cu",
                        _REF + "ops/mcica_pallas.py:588", "step"),
    "taumol_lw": (_CSRC + "taumol_lw.cu",
                  _REF + "models/rrtmg/taumol_lw_pallas.py:457", "step"),
    "rtrnmc": (_CSRC + "rtrnmc.cu",
               _REF + "models/rrtmg/rtrnmc_pallas.py:239", "step"),
    "taumol_sw": (_CSRC + "taumol_sw.cu",
                  _REF + "models/rrtmg/taumol_sw_pallas.py:246", "step"),
    "spcvmc": (_CSRC + "spcvmc.cu",
               _REF + "models/rrtmg/spcvmc_pallas.py:454", "step"),
    "mcica_subcols_raw": (_CSRC + "mcica_raw.cu",
                          _REF + "ops/mcica_pallas.py:483", "verify"),
    "ffill": (_CSRC + "ffill.cu",
              "tools/profiling/fused_mcica_check.py:56", "profiling"),
    "gather_rows": (_CSRC + "gather_micro.cu",
                    "tools/profiling/gather_micro.py:63", "profiling"),
    "gather_lanes": (_CSRC + "gather_micro.cu",
                     "tools/profiling/gather_micro.py:96", "profiling"),
    "taumol_lw_bisect": (_CSRC + "taumol_lw_bisect.cu",
                         "tools/profiling/taumol_lw_bisect.py:58",
                         "profiling"),
}


def require_launched(launches, path):
    """Raise unless every kernel of the path launched in its run."""
    for name, (_, _, p) in SOURCES.items():
        if p == path and launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the full-width refresh")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs only "
                         "on a GPU")
    from geosradiation_gridcomp_tpu_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")

    dev = torch.device("cuda", 0)
    results = kernel_phases(torch, dev)
    results.update(raw_and_profiling_kernel_phases(torch, dev))
    launches, step = step_phase(torch, dev)
    if args.profile:
        profile_phase(torch, step)
    paths = {"step": launches, "verify": verify_path(torch),
             "profiling": profiling_path(torch)}
    for path in ("verify", "profiling"):
        print(f"  kernel launches in the {path} path: {paths[path]}")
        require_launched(paths[path], path)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = []
    for name, (source, replaces, path) in SOURCES.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, path=path,
                            launches=paths[path][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
