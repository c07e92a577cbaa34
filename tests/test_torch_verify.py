"""The port's verification suite (tools/verify.py) on the CPU, where every
kernel wrapper runs its plain twin, at 16 columns x 72 levels.

Every gate passes. The same-draws zcw A/B delta of the suite (the column-
mean LW flux bias of the TPU kernels' zcw fit against the exact table, on
K7's draws) agrees within 1e-3 W/m^2 with the same quantity computed by
the JAX CPU functions (_zcw_eval, zcw_lookup_class, cldprmc_lw, rtrnmc)
on the same draws and the same gas optics (measured: 1.26e-4 against
1.30e-4 W/m^2 up, 5.86e-4 against 5.82e-4 down). The entry point refuses
to run without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.models.rrtmg import rtrnmc as jrt
from geosradiation_gridcomp_tpu.models.rrtmg.cldprmc_lw import \
    cldprmc_lw as j_cldprmc
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu.ops import mcica_pallas as mp
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import mcica_subcols_raw
from geosradiation_gridcomp_tpu_torch.tools import verify

torch.set_num_threads(1)

NCOL = 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def report():
    return verify.run_gates(CPU, NCOL, log=lambda *a: None)


def test_every_gate_passes(report):
    assert report["ncol"] == NCOL and report["nlev"] == 72
    assert len(report["gates"]) == 40
    failed = [k for k, g in report["gates"].items() if not g["pass"]]
    assert not failed and report["ok"]


def _jax_ab_delta():
    """zcw_fit_ab_same_rng's delta by the JAX functions, on the port's
    draws and gas optics."""
    s = verify.lw_setup(CPU, NCOL)
    cloudy, v3 = mcica_subcols_raw(s["keys"], *s["k1"][1:4], nsub=140)
    n = lambda x: jnp.asarray(x.numpy())
    sig = s["sigcls"].numpy()[:, :, None]
    v = n(v3)
    zcws = dict(
        fit=mp._zcw_eval(v, (jnp.asarray(sig == 0), jnp.asarray(sig == 1)),
                         mp._zcw_fit(1)),
        exact=jm.zcw_lookup_class(
            v, jnp.asarray(np.broadcast_to(sig, v.shape)), 1))
    cw = n(cloudy) > 0.0
    ciwp, clwp = n(s["ciwp"])[:, :, None], n(s["clwp"])[:, :, None]
    co = s["coefs"]
    means = {}
    for name, zcw in zcws.items():
        ci = jnp.where(cw, ciwp * zcw, 0.0)
        cl = jnp.where(cw, clwp * zcw, 0.0)
        ci = jnp.where(ci <= 1e-20, 0.0, ci)
        cl = jnp.where(cl <= 1e-20, 0.0, cl)
        cldy = cw & ((ci > 0.0) | (cl > 0.0))
        sw = lambda x: jnp.swapaxes(x, 1, 2)
        tau_gl, cldy_col = j_cldprmc(sw(cldy), sw(ci), sw(cl),
                                     n(s["inp"].ri), n(s["inp"].rl))
        o = jrt.rtrnmc(n(s["emis"]), n(s["taug"]), n(s["pfracs"]), cldy_col,
                       jnp.swapaxes(tau_gl, -1, -2), n(co.planklay),
                       n(co.planklev), n(co.plankbnd), n(co.dplankbnd_dts),
                       n(co.pwvcm), dudts=False)
        means[name] = {k: np.asarray(o[k], np.float64).mean(0)
                       for k in ("uflx", "dflx")}
    return {k: float(np.abs(means["fit"][k] - means["exact"][k]).max())
            for k in ("uflx", "dflx")}


def test_zcw_ab_delta_agrees_with_jax(report):
    want = _jax_ab_delta()
    for k, w in want.items():
        got = report["gates"][f"zcw_fit_ab_same_rng.{k} (W/m2)"]["err"]
        assert w > 0.0 and abs(got - w) <= 1e-3, (k, got, w)


def test_main_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "verify.json"
    with pytest.raises(SystemExit):
        verify.main(["--quick", "--out", str(out)])
    assert not out.exists()
