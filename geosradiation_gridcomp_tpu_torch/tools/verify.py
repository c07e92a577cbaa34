"""Verification suite of the port on one NVIDIA GPU: the CUDA kernels
against their plain twins at production shape, and the McICA contract.

    python -m geosradiation_gridcomp_tpu_torch.tools.verify [--quick]
        [--out PATH]

Port of the reference's tools/verify_tpu.py, gate for gate (the same
names and tolerances), with the port's CUDA kernels K1-K7 in place of the
Pallas kernels and their plain PyTorch twins (the plain=True paths) in
place of the jnp oracles, on the scene.example_inputs scene (seed 0) at
2048 columns x 72 levels (512 with --quick):

  taumol_lw_fast.*, rtrnmc_fast.*, taumol_sw_pallas.*, spcvmc_fast.*:
      K3, K4, K5, K6 elementwise against their twins (relmax < 5e-4);
  mcica_lw_fused.*: K1's determinism and column-permutation invariance
      (the reference's own contract, cloud_subcol_gen.F90:24-31) and the
      subcolumn cloud-fraction population against the input (< 0.06);
  fused_vs_oracle_meanflux.*: the LW all-sky column-mean fluxes of
      rrtmg_lw with the kernels against the plain pipeline, within
      max(0.5, 2.5 x the largest of three reseeded plain runs' deviation)
      W/m^2;
  clearsky_e2e_lw.*, clearsky_e2e_sw.*: the clear-sky schemes with the
      kernels against the plain solvers (LW relmax < 5e-5; SW relmax
      < 5e-4 with at most 0.5 % of columns beyond 5e-5);
  zcw_fit_ab_same_rng.*: on K7's draws, the TPU kernels' zcw fit
      (ops/zcw_fit.py) against the exact class table, through cldprmc_lw
      and K4: the fit's column-mean flux bias (< 0.1 W/m^2);
  mcica_raw_vs_lw_fused.*: the port's own gate: K7's draws with the exact
      table reproduce K1's cloudy mask exactly and its cloud optical
      depth to relmax < 1e-6 on the same seeds (the reference shares its
      draw code between the two kernels for this property). K7 takes
      ops.mcica.subcolumn_keys; K1 derives its subkeys from play in its
      prologue, so the gate also holds those to subcolumn_keys;
  mcica_raw_vs_sw_fused.cloudy_mismatches: the same for K2 and the SW
      seed order, on 112 subcolumns: K7's draws from the SW subkeys with
      the exact table reproduce K2's cloudy mask exactly.

relmax is max|a - b| / max|b| (verify_tpu.py:33-36). The report (every
gate's error, tolerance and verdict, the sizes and the card) goes to
--out, by default build/verify_gpu.json of the checkout; the exit code is
non-zero if a gate fails. main() needs a CUDA device; run_gates(dev,
ncol) is the suite itself, which the CPU tests drive with the twins.
"""

import argparse
import json
import os

import numpy as np
import torch

from ..models.rrtmg import lw as lwm
from ..models.rrtmg import sw as swm
from ..models.rrtmg.cldprmc_lw import band_abs_coeffs_lw, cldprmc_lw
from ..models.rrtmg.rtrnmc import rtrnmc
from ..models.rrtmg.rtrnmc_cuda import rtrnmc_fast
from ..models.rrtmg.setcoef_lw import setcoef_lw
from ..models.rrtmg.setcoef_sw import setcoef_sw
from ..models.rrtmg.spcvmc import spcvmc_sw
from ..models.rrtmg.spcvmc_cuda import spcvmc_fast
from ..models.rrtmg.taumol_lw import taumol_lw
from ..models.rrtmg.taumol_lw_cuda import taumol_lw_fast
from ..models.rrtmg.taumol_sw import sfluxzen_only, taumol_sw
from ..models.rrtmg.taumol_sw_cuda import taumol_sw_fast
from ..ops import mcica
from ..ops.mcica_cuda import (mcica_optics_lw, mcica_optics_lw_plain,
                              mcica_optics_sw, mcica_optics_sw_plain,
                              mcica_subcols_raw)
from ..ops.zcw_fit import zcw_eval, zcw_fit
from ..scene import example_inputs

DOY = 172.0
CLOUD_MH, CLOUD_LM = 28, 47
CWP_TINY = 1.0e-20
OUT_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "verify_gpu.json")


def relmax(a, b, floor=1e-6):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


def lw_setup(dev, ncol, nlev=72):
    """The LW state of the suite, as verify_tpu.py:84-111 forms it: the
    scene, its derived fields, setcoef_lw with dF/dTs, the plain taumol
    K1's arguments and the subkeys K7 takes. Returns a dict."""
    inp = example_inputs(ncol, nlev, seed=0, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    play = 0.01 * 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    plev = inp.ple * 0.01
    tlev = lwm.level_temperatures(play, inp.t, plev, inp.ts)
    zm = lwm.mid_heights(play, inp.t, inp.ple[:, -1])
    emis = inp.emis[:, None].expand(ncol, 16).contiguous()
    h2o = inp.qv / (1.0 - inp.qv) * (28.964 / 18.015)
    o3 = inp.o3 * (28.964 / 47.998)
    dp = inp.ple[:, 1:] - inp.ple[:, :-1]
    ciwp = 1000.0 * inp.qi * dp / 9.80665
    clwp = 1000.0 * inp.ql * dp / 9.80665

    def c(v):
        return torch.full_like(play, v)

    gases = (h2o, o3, c(4e-4), c(1.8e-6), c(3.2e-7), c(0.209), c(0.0),
             c(2e-10), c(4e-10), c(1e-10), c(0.0))
    coefs = setcoef_lw(play, inp.t, plev, tlev, inp.ts, emis, *gases,
                       lw.planck_tables, dudts=True)
    taug, pfracs = taumol_lw(coefs, lw.taumol_tables)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    sigcls = mcica._sigma_class(inp.fcld)
    absi, absl = band_abs_coeffs_lw(inp.ri, inp.rl, lw.cloud_tables)
    k1 = (play, alpha, rcorr, inp.fcld, ciwp, clwp, sigcls,
          absi.contiguous(), absl.contiguous(), lw.zcw_cols(1))
    return dict(inp=inp, lw=lw, play=play, plev=plev, tlev=tlev, zm=zm,
                emis=emis, h2o=h2o, o3=o3, c=c, gases=gases, ciwp=ciwp,
                clwp=clwp, coefs=coefs, taug=taug, pfracs=pfracs,
                alpha=alpha, rcorr=rcorr, sigcls=sigcls, k1=k1,
                keys=mcica.subcolumn_keys(play))


def planck_args(s):
    """rtrnmc's arguments after taucmc."""
    co = s["coefs"]
    return (co.planklay, co.planklev, co.plankbnd, co.dplankbnd_dts,
            co.pwvcm)


def ab_paths(cloudy, zcw, ciwp, clwp):
    """Water paths and cloud mask from raw draws and a zcw field, all
    [ncol, nlay, nsub], as the generator forms them."""
    zero = torch.zeros((), dtype=zcw.dtype, device=zcw.device)
    cw = cloudy > 0.0
    ci = torch.where(cw, ciwp[:, :, None] * zcw, zero)
    cl = torch.where(cw, clwp[:, :, None] * zcw, zero)
    ci = torch.where(ci <= CWP_TINY, zero, ci)
    cl = torch.where(cl <= CWP_TINY, zero, cl)
    return cw & ((ci > 0.0) | (cl > 0.0)), ci, cl


def ab_fluxes(s, cldy, ci, cl):
    """LW fluxes (K4, no dF/dTs) for [ncol, nlay, nsub] subcolumn clouds,
    and the cloud optics behind them ([ncol, nlay, nsub] tau, [ncol, nlay]
    mask)."""
    inp = s["inp"]
    tau_gl, cloudy = cldprmc_lw(cldy.transpose(1, 2), ci.transpose(1, 2),
                                cl.transpose(1, 2), inp.ri, inp.rl,
                                s["lw"].cloud_tables)
    tau = tau_gl.transpose(1, 2).contiguous()
    out = rtrnmc_fast(s["emis"], s["taug"], s["pfracs"], cloudy, tau,
                      *planck_args(s), dudts=False)
    return out, tau, cloudy


def run_gates(dev, ncol, nlev=72, log=print):
    """Every gate of the suite on device dev at ncol x nlev; returns the
    report dict ({"ncol", "nlev", "device", "gates", "ok"})."""
    report = {"ncol": ncol, "nlev": nlev,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else str(dev)),
              "gates": {}}

    def gate(name, err, tol):
        passed = bool(err < tol)
        report["gates"][name] = {"err": err, "tol": tol, "pass": passed}
        log(f"{name:42s} err={err:.3e} tol={tol:.0e} "
            f"{'PASS' if passed else 'FAIL'}")

    s = lw_setup(dev, ncol, nlev)
    inp, lw, coefs, c = s["inp"], s["lw"], s["coefs"], s["c"]
    play, emis, zm = s["play"], s["emis"], s["zm"]
    taug, pfracs = s["taug"], s["pfracs"]
    mc = dict(cloud_mh=CLOUD_MH, cloud_lm=CLOUD_LM)

    # ---- deterministic kernels: elementwise parity --------------------
    tg_f, pf_f = taumol_lw_fast(coefs, lw.taumol_tables)
    gate("taumol_lw_fast.taug", relmax(tg_f, taug), 5e-4)
    gate("taumol_lw_fast.pfracs", relmax(pf_f, pfracs), 5e-4)
    taucmc, cloudy, _ = mcica_optics_lw_plain(*s["k1"], **mc)
    rt_args = (emis, taug, pfracs, cloudy, taucmc, *planck_args(s))
    a = rtrnmc(*rt_args, dudts=True)
    b = rtrnmc_fast(*rt_args, dudts=True)
    for k in ("uflx", "dflx", "uflxc", "dflxc", "duflx_dts", "olrb"):
        gate(f"rtrnmc_fast.{k}", relmax(b[k], a[k]), 5e-4)

    sw = swm.RRTMGSW.from_reference_tables(dev)
    scoefs = setcoef_sw(play, inp.t, s["plev"], s["h2o"], s["o3"], c(4e-4),
                        c(1.8e-6), c(0.2095), sw.reference_tables)
    svw = swm.solar_source_weights(-1, 1361.0, None, None, None)
    tg_s, tr_s = taumol_sw(scoefs, sw.taumol_tables)
    sflux = sfluxzen_only(scoefs, sw.solar_sources(svw))
    tg_p, tr_p = taumol_sw_fast(scoefs, sw.taumol_tables)
    gate("taumol_sw_pallas.taug", relmax(tg_p, tg_s), 5e-4)
    gate("taumol_sw_pallas.taur", relmax(tr_p, tr_s), 5e-4)
    k2 = (*s["k1"][:7], inp.ri, inp.rl, sw.cloud_pack(3), sw.zcw_cols(1))
    mc_sw = dict(mc, seed_order=swm.SEED_ORDER_SW)
    tc, sc, ac, cy, _ = mcica_optics_sw_plain(*k2, **mc_sw)
    mu0 = torch.clamp(torch.cos(inp.lats), 0.05, 1.0)
    albdir = inp.albvr[:, None].expand(ncol, 14).contiguous()
    albdif = inp.albvf[:, None].expand(ncol, 14).contiguous()
    sp_args = (None, tg_s, tr_s, sflux, mu0, albdir, albdif, cy, tc, sc, ac)
    a = spcvmc_sw(*sp_args)
    b = spcvmc_fast(*sp_args)
    for k in ("bbfd", "bbfu", "bbcd", "bbcu", "bbfddir", "nirr", "parf",
              "fndsbnd", "drband"):
        gate(f"spcvmc_fast.{k}", relmax(b[k], a[k]), 5e-4)

    # ---- stochastic kernel K1: determinism + population stats ---------
    t1, cl1, _ = mcica_optics_lw(*s["k1"], **mc)
    t2, _, _ = mcica_optics_lw(*s["k1"], **mc)
    perm = torch.as_tensor(np.random.default_rng(0).permutation(ncol),
                           device=dev)
    tp, _, _ = mcica_optics_lw(*(x[perm].contiguous()
                                 for x in s["k1"][:9]), s["k1"][9], **mc)
    gate("mcica_lw_fused.determinism",
         0.0 if torch.equal(t1, t2) else 1.0, 0.5)
    gate("mcica_lw_fused.perm_invariance",
         0.0 if torch.equal(tp, t1[perm]) else 1.0, 0.5)
    cf = (t1 > 0).double().mean(dim=2)
    sel = inp.fcld > 0
    gate("mcica_lw_fused.cldfrac_population",
         float((cf[sel] - inp.fcld[sel].double()).abs().mean()), 0.06)

    # ---- end-to-end LW mean-flux bound --------------------------------
    lwargs = (inp.ple, play, inp.t, s["tlev"], inp.ts, emis, *s["gases"],
              inp.fcld, s["ciwp"], s["clwp"], inp.ri, inp.rl, zm,
              inp.lats, DOY)
    out_f = lwm.rrtmg_lw(lw, *lwargs, **mc)
    out_o = rtrnmc(*rt_args, dudts=True)
    # the plain pipeline reseeded: the spread of the column means that
    # realization noise alone gives (verify_tpu.py:194-215)
    noise = []
    for so in ((1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)):
        tau_n, cloudy_n, _ = mcica_optics_lw_plain(*s["k1"], seed_order=so,
                                                   **mc)
        out_n = rtrnmc(emis, taug, pfracs, cloudy_n, tau_n,
                       *planck_args(s), dudts=True)
        noise.append({k: out_n[k].double().mean(0) for k in ("uflx", "dflx")})
    for k in ("uflx", "dflx"):
        mean_o = out_o[k].double().mean(0)
        nz = max(float((nm[k] - mean_o).abs().max()) for nm in noise)
        err = float((out_f[k].double().mean(0) - mean_o).abs().max())
        gate(f"fused_vs_oracle_meanflux.{k} (W/m2)", err, max(0.5, 2.5 * nz))

    # ---- clear-sky end to end: kernels vs the plain solvers -----------
    z2 = torch.zeros_like(inp.fcld)
    clear = (z2, z2, z2, inp.ri, inp.rl, zm, inp.lats, DOY)
    out_p = lwm.rrtmg_lw(lw, *lwargs[:17], *clear, **mc)
    out_c = rtrnmc(emis, taug, pfracs, torch.zeros_like(inp.fcld,
                                                        dtype=torch.bool),
                   torch.zeros_like(taug), *planck_args(s), dudts=True)
    for k in ("uflx", "dflx", "duflx_dts"):
        gate(f"clearsky_e2e_lw.{k}", relmax(out_p[k], out_c[k]), 5e-5)
    mu0d = torch.clamp(torch.cos(inp.lats), 0.05, 1.0)
    outs_p = swm.rrtmg_sw(sw, inp.ple, play, inp.t, mu0d, inp.albvr,
                          inp.albvf, inp.albnr, inp.albnf, s["h2o"],
                          s["o3"], c(4e-4), c(1.8e-6), c(0.2095), *clear,
                          **mc)
    uv = torch.as_tensor(swm._UVBAND, device=dev)
    abd = torch.where(uv, inp.albvr[:, None], inp.albnr[:, None])
    abf = torch.where(uv, inp.albvf[:, None], inp.albnf[:, None])
    tc0 = torch.zeros_like(tg_s)
    outs_c = spcvmc_sw(scoefs, tg_s, tr_s, sflux, mu0d, abd, abf,
                       torch.zeros_like(tc0, dtype=torch.bool), tc0, tc0,
                       tc0)
    for k in ("bbfu", "bbfd", "bbcu", "bbcd"):
        e = (outs_p[k].double() - outs_c[k].double()).abs() \
            / max(float(outs_c[k].abs().max()), 1e-6)
        gate(f"clearsky_e2e_sw.{k}.flipped_cols",
             float((e.max(dim=1).values > 5e-5).double().mean()), 0.005)
        gate(f"clearsky_e2e_sw.{k}.max", float(e.max()), 5e-4)

    # ---- same-draws zcw A/B on K7: polynomial fit vs exact table ------
    cldy_raw, v3 = mcica_subcols_raw(s["keys"], *s["k1"][1:4], nsub=140)
    cls = s["sigcls"][:, :, None]
    zcws = dict(fit=zcw_eval(v3, (cls == 0, cls == 1), zcw_fit(1)),
                exact=mcica.zcw_lookup_class(v3, cls.expand_as(v3),
                                             lw.zcw_cols(1)))
    means, optics = {}, {}
    for name, zcw in zcws.items():
        out, tau, cloudy_ab = ab_fluxes(s, *ab_paths(cldy_raw, zcw,
                                                     s["ciwp"], s["clwp"]))
        means[name] = {k: out[k].double().mean(0) for k in ("uflx", "dflx")}
        optics[name] = (tau, cloudy_ab)
    for k in ("uflx", "dflx"):
        err = float((means["fit"][k] - means["exact"][k]).abs().max())
        gate(f"zcw_fit_ab_same_rng.{k} (W/m2)", err, 0.1)

    # ---- K7's draws + exact table against K1 on the same seeds --------
    tau_ex, cloudy_ex = optics["exact"]
    gate("mcica_raw_vs_lw_fused.cloudy_mismatches",
         float((cloudy_ex != cl1).sum()), 0.5)
    gate("mcica_raw_vs_lw_fused.taucmc", relmax(tau_ex, t1), 1e-6)
    cldy_sw, v3_sw = mcica_subcols_raw(mcica.subcolumn_keys(
        play, swm.SEED_ORDER_SW), *s["k1"][1:4], nsub=112)
    zcw_sw = mcica.zcw_lookup_class(v3_sw, cls.expand_as(v3_sw),
                                    sw.zcw_cols(1))
    cy_k2 = mcica_optics_sw(*k2, **mc_sw)[3]
    gate("mcica_raw_vs_sw_fused.cloudy_mismatches",
         float((ab_paths(cldy_sw, zcw_sw, s["ciwp"], s["clwp"])[0]
                != cy_k2).sum()), 0.5)

    report["ok"] = all(g["pass"] for g in report["gates"].values())
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="ncol=512 instead of 2048")
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--out", default=OUT_DEFAULT,
                    help="where the JSON report goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("verify: no CUDA device; this suite runs only on "
                         "a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = run_gates(torch.device("cuda", 0), 512 if args.quick else 2048,
                       args.nlev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("overall:", "PASS" if report["ok"] else "FAIL")
    if not report["ok"]:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
