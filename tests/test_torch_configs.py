"""The port's RRTMG refresh + update against the JAX CPU oracle under the
configurations the other parity tests leave to the kernel-vs-twin tests:
condensate_inhomogeneity 0 and 2, ts_derivs=False, no lazy outputs,
isolvar 0-3 and solar_constant=0, iceflag_lw 0-2 and 4, iceflag_sw 1-2.

Realistic scene, 8 columns x 72 levels, seed 0, doy 172, 12 UTC, every
column solved (no daylight packing). Gates (relmax = max|a-b| / max|b|,
tools/verify_tpu.py:33-36): every IrradState field and LW export <= 5e-5,
every SolarState field and SW export <= 5e-5, alw/blw <= 5e-5; the SW
McICA clear-subcolumn counts behind the cloud fractions exactly equal.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.config import Scheme as TScheme
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
GATE_LW = GATE_SW = 5e-5

CONFIGS = {
    "inhm0": dict(condensate_inhomogeneity=0),
    "inhm2": dict(condensate_inhomogeneity=2),
    "no_ts_derivs": dict(ts_derivs=False),
    "no_outputs": dict(outputs=frozenset()),
    "isolvar0": dict(isolvar=0),
    "isolvar1": dict(isolvar=1, solcycfrac=0.3),
    "isolvar2": dict(isolvar=2, indsolvar=(0.158, 1000.0)),
    "isolvar3": dict(isolvar=3),
    "scon0": dict(solar_constant=0.0),
    "iceflag_lw0": dict(iceflag_lw=0),
    "iceflag_lw1": dict(iceflag_lw=1),
    "iceflag_lw2": dict(iceflag_lw=2),
    "iceflag_lw4": dict(iceflag_lw=4),
    "iceflag_sw1": dict(iceflag_sw=1),
    "iceflag_sw2": dict(iceflag_sw=2),
}


def port_config(c):
    """The port's RadiationConfig with the fields of the reference's c."""
    return TConfig(**{f.name: TScheme(v.value) if isinstance(v, Scheme)
                      else v for f in dataclasses.fields(c)
                      for v in (getattr(c, f.name),)})


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


@pytest.fixture(scope="module")
def scene():
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    ict, icb = RadiationConfig().superlayer_indices(pmid)
    mods = dict(sw=RRTMGSW.from_reference_tables("cpu"),
                lw=RRTMGLW.from_reference_tables("cpu"))
    return ji, ti, ict, icb, mods


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_oracle(scene, name):
    ji, ti, ict, icb, mods = scene
    cfg = RadiationConfig(**CONFIGS[name])
    tcfg = port_config(cfg)
    js = jstep.radiation_refresh(ji, DOY, UTC, config=cfg, ict=ict, icb=icb)
    ts = tstep.radiation_refresh(ti, DOY, UTC, config=tcfg, ict=ict, icb=icb,
                                 **mods)
    ju = jstep.radiation_update(*js, ji.tsinst + 0.5, ji.lons, ji.lats,
                                ji.ple, DOY, UTC + 0.25, config=cfg)
    tu = tstep.radiation_update(*ts, ti.tsinst + 0.5, ti.lons, ti.lats,
                                ti.ple, DOY, UTC + 0.25, config=tcfg)
    for state, gate in ((0, GATE_SW), (1, GATE_LW)):
        for f in ts[state]._fields:
            a, b = getattr(ts[state], f), np.asarray(getattr(js[state], f))
            assert tuple(a.shape) == b.shape, f
            assert relmax(a.numpy(), b) <= gate, f
    # the clear-subcolumn counts behind the cloud fractions, exactly (the
    # oracle's 1 - n / 112 multiplies by a rounded 1 / 112)
    np.testing.assert_array_equal(
        np.rint((1.0 - ts[0].cldfrc.double().numpy()) * 112.0),
        np.rint((1.0 - np.asarray(js[0].cldfrc, np.float64)) * 112.0))
    assert set(tu) == set(ju)
    for group, gate in (("sw", GATE_SW), ("lw", GATE_LW)):
        assert set(tu[group]) == set(ju[group])
        for k in ju[group]:
            assert relmax(tu[group][k].numpy(),
                          np.asarray(ju[group][k])) <= gate, (group, k)
    for k in ("alw", "blw"):
        assert relmax(tu[k].numpy(), np.asarray(ju[k])) <= GATE_LW, k
