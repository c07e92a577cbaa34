"""The port's IRRAD refresh and per-heartbeat exports against the JAX CPU
oracle on the realistic scene (8 columns x 72 levels): every IrradState
field and every export <= 5e-5 relmax (max|a-b| / max|b|, the LW
end-to-end gate of tools/verify_tpu.py:243).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.config import Scheme as TScheme
from geosradiation_gridcomp_tpu_torch.driver import radiation as trad
from geosradiation_gridcomp_tpu_torch.driver.state import IrradState
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY = 8, 72, 172.0
FIELDS = IrradState._fields
CFG_NA = RadiationConfig(outputs=frozenset(
    {"olrb", "tbrb", "clear_counts", "no_aerosol"}))


def port_config(c):
    """The port's RadiationConfig with the fields of the reference's c."""
    return TConfig(**{f.name: TScheme(v.value) if isinstance(v, Scheme)
                      else v for f in dataclasses.fields(c)
                      for v in (getattr(c, f.name),)})


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def _taua():
    rng = np.random.default_rng(5)
    return rng.uniform(0.0, 0.05, (NCOL, NLEV, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """JAX and port refreshes: default config, and aerosol with the
    no-aerosol second pass."""
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    lw = RRTMGLW.from_reference_tables("cpu")
    taua = _taua()
    out = {}
    for name, c, ta in (("default", cfg, None), ("aerosol", CFG_NA, taua)):
        js = jrad.irrad_refresh(ji, DOY, c, ict, icb,
                                taua=None if ta is None else jnp.asarray(ta))
        ts = trad.irrad_refresh(
            ti, DOY, port_config(c), ict, icb, lw=lw,
            taua=None if ta is None else torch.as_tensor(ta))
        out[name] = (js, ts, c)
    return ji, ti, out


def test_derived_inputs(runs):
    ji, ti, _ = runs
    pairs = [*zip(jrad._cwc_reff(ji), trad._cwc_reff(ti)),
             *zip(jrad._common_derived(ji), trad._common_derived(ti)),
             *zip(jrad._incloud_paths(ji), trad._incloud_paths(ti))]
    for a, b in pairs:
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("field", FIELDS)
def test_irrad_refresh_default(runs, field):
    _, _, out = runs
    js, ts, _ = out["default"]
    a, b = getattr(ts, field), np.asarray(getattr(js, field))
    assert tuple(a.shape) == b.shape
    assert relmax(a.numpy(), b) <= 5e-5


@pytest.mark.parametrize("field", FIELDS)
def test_irrad_refresh_aerosol_second_pass(runs, field):
    _, _, out = runs
    js, ts, _ = out["aerosol"]
    assert relmax(getattr(ts, field).numpy(),
                  np.asarray(getattr(js, field))) <= 5e-5


def test_aerosol_changes_fluxes(runs):
    _, _, out = runs
    assert relmax(out["aerosol"][1].flx.numpy(),
                  out["default"][1].flx.numpy()) > 1e-3


@pytest.mark.parametrize("name", ["default", "aerosol"])
def test_irrad_update_and_linearization(runs, name):
    ji, ti, out = runs
    js, ts, cfg = out[name]
    ju = jrad.irrad_update(js, ji.tsinst + 0.5, cfg)
    tu = trad.irrad_update(ts, ti.tsinst + 0.5, port_config(cfg))
    assert set(tu) == set(ju)
    for k in ju:
        assert relmax(tu[k].numpy(), np.asarray(ju[k])) <= 5e-5, k
    jl = jrad.surface_lw_linearization(js)
    tl = trad.surface_lw_linearization(ts)
    for k in jl:
        assert relmax(tl[k].numpy(), np.asarray(jl[k])) <= 5e-5, k


def test_heating_rates(runs):
    """Same flux profiles in, same heating rates out; and the port's own
    refresh gives physical LW heating below 100 hPa."""
    ji, ti, out = runs
    js, ts, _ = out["default"]
    rng = np.random.default_rng(2)
    fsw = rng.uniform(0.0, 300.0, js.flx.shape).astype(np.float32)
    flw = np.array(js.flx)
    jh = jrad.heating_rates(jnp.asarray(fsw), jnp.asarray(flw), ji.ple)
    th = trad.heating_rates(torch.as_tensor(fsw), torch.as_tensor(flw),
                            ti.ple)
    assert relmax(th.numpy(), np.asarray(jh)) <= 5e-5
    hr = trad.heating_rates(torch.zeros_like(ts.flx), ts.flx, ti.ple)
    play = 0.5 * (ti.ple[:, 1:] + ti.ple[:, :-1])
    assert torch.isfinite(hr).all()
    assert float((hr * 86400.0)[play > 1.0e4].abs().max()) < 50.0


def test_physical_fluxes(runs):
    ji, ti, out = runs
    ts = out["default"][1]
    olr = -ts.flx[:, 0]
    assert float(olr.min()) > 150.0 and float(olr.max()) < 350.0
    assert all(torch.isfinite(x).all() for x in ts)


@pytest.mark.parametrize("scheme", [TScheme.RRTMGP])
def test_unported_schemes_raise(scheme):
    """RRTMGP, once the LW scheme the port lacked, no longer raises: its
    branch returns a finite IrradState (tests/test_torch_rrtmgp_driver.py
    holds it to the oracle)."""
    ti = example_inputs(2, 10, device="cpu")
    st = trad.irrad_refresh(ti, DOY, TConfig(lw_scheme=scheme), 3, 6)
    assert all(torch.isfinite(x).all() for x in st)
    assert float(st.flxu[:, 0].min()) > 0.0


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import geosradiation_gridcomp_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 20, mods\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules "
        "if m.startswith('jax')]\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
