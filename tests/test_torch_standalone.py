"""The port stands alone: it loads neither jax nor the reference package,
its copies of the reference's numpy-only modules equal the originals, and
its constructors put their tensors on the card unless asked for the CPU.

Only this test imports both packages' copies side by side; every
comparison is exact (the copies are the same code on the same npz data).
"""

import dataclasses
import glob
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu import config as ref_config
from geosradiation_gridcomp_tpu import constants as ref_constants
from geosradiation_gridcomp_tpu import tables as ref_tables
from geosradiation_gridcomp_tpu.driver import clock as ref_clock
from geosradiation_gridcomp_tpu.driver import solar_cycle as ref_solar_cycle
from geosradiation_gridcomp_tpu.models.rrtmg import nrlssi2 as ref_nrlssi2
from geosradiation_gridcomp_tpu.models.rrtmg import tables_lw as ref_tlw
from geosradiation_gridcomp_tpu.models.rrtmg import tables_sw as ref_tsw
from geosradiation_gridcomp_tpu_torch import config, constants, tables
from geosradiation_gridcomp_tpu_torch.driver import clock, solar_cycle
from geosradiation_gridcomp_tpu_torch.models.rrtmg import (cldprmc_lw,
                                                           cldprmc_sw, lw,
                                                           nrlssi2, sw,
                                                           tables_lw,
                                                           tables_sw,
                                                           taumol_sw)
from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "geosradiation_gridcomp_tpu_torch"
# the entry modules: the step and its driver, the driver infrastructure
# and RATS, the Chou-Suarez and RRTMGP schemes, the column sharding and
# staged feed, the satellite simulators, the verification suite and
# every module under tools/profiling
ENTRY_MODULES = (
    "driver.step", "driver.radiation", "driver.diagnostics", "driver.clock",
    "driver.validate", "driver.checkpoint", "driver.solar_cycle",
    "ops.twostream", "ops.chou_optics", "models.chou_sw", "models.chou_lw",
    "models.rrtmgp.scheme", "parallel.sharding", "parallel.distributed",
    "satsim", "satsim.cosp", "satsim.radar", "tools.verify") + tuple(
    f"tools.profiling.{m.name}" for m in pkgutil.iter_modules(
        [os.path.join(ROOT, PKG, "tools", "profiling")]))


@pytest.mark.parametrize("module", ENTRY_MODULES)
def test_entry_module_loads_no_jax_and_no_reference(module):
    code = (f"import sys, importlib; importlib.import_module('{PKG}.{module}')"
            "\nbad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'geosradiation_gridcomp_tpu' or "
            "k.startswith('geosradiation_gridcomp_tpu.'))\nprint(bad)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_port_sources_import_no_jax_and_no_reference():
    files = glob.glob(os.path.join(ROOT, PKG, "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for f in files:
        for line in open(f):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod.split(".")[0] not in (
                    "jax", "geosradiation_gridcomp_tpu"), (f, line)


def test_config_copy():
    ref = {f.name: f.default for f in dataclasses.fields(
        ref_config.RadiationConfig)}
    port = {f.name: f.default for f in dataclasses.fields(
        config.RadiationConfig)}
    assert list(port) == list(ref)
    for name, default in ref.items():
        if isinstance(default, ref_config.Scheme):
            assert port[name].value == default.value, name
        else:
            assert port[name] == default, name
    assert [s.value for s in config.Scheme] == [
        s.value for s in ref_config.Scheme]
    for a in (False, True):
        for b in (False, True):
            assert config.choose_scheme(a, b).value == \
                ref_config.choose_scheme(a, b).value
    ple = example_inputs(1, 72, device="cpu").ple[0].numpy()
    pref = 0.5 * (ple[1:] + ple[:-1])
    for kw in ({}, dict(prs_mid_high_clouds=30000.0,
                        prs_low_mid_clouds=80000.0)):
        assert config.RadiationConfig(**kw).superlayer_indices(pref) == \
            ref_config.RadiationConfig(**kw).superlayer_indices(pref)
    for kw in ({}, dict(solar_constant=0.0),
               dict(solar_constant=0.0, isolvar=0)):
        assert config.RadiationConfig(**kw).effective_scon() == \
            ref_config.RadiationConfig(**kw).effective_scon()
    for out in ("olrb", "tbrb", "band_sfc", "clear_counts", "other"):
        for outputs in (frozenset(), frozenset({"tbrb"}),
                        ref_config.RadiationConfig().outputs):
            assert config.RadiationConfig(outputs=outputs).wants(out) == \
                ref_config.RadiationConfig(outputs=outputs).wants(out)


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def test_constants_copy():
    ref = _public(ref_constants)
    assert _public(constants) == ref and len(ref) > 10


def _assert_same(a, b, where):
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple, np.ndarray)) or np.isscalar(b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    tables.DATA_DIR, "*.npz"))), ids=os.path.basename)
def test_tables_load_copy(path):
    tag = os.path.basename(path)[:-4]
    _assert_same(tables.load(tag), ref_tables.load(tag), tag)


def test_tables_load64_copy():
    _assert_same(tables.load64("nrlssi2"), ref_tables.load64("nrlssi2"),
                 "nrlssi2")


def test_tables_lw_copy():
    _assert_same(tables_lw.lw_tables(), ref_tlw.lw_tables(), "lw_tables")
    _assert_same(tables_lw.lw_gather_tables(), ref_tlw.lw_gather_tables(),
                 "lw_gather_tables")
    port = _public(tables_lw)
    assert len(port) > 10
    for k, v in port.items():
        _assert_same(v, getattr(ref_tlw, k), k)


def test_tables_sw_copy():
    _assert_same(tables_sw.sw_tables(), ref_tsw.sw_tables(), "sw_tables")
    port = _public(tables_sw)
    assert len(port) == 10
    for k, v in port.items():
        _assert_same(v, getattr(ref_tsw, k), k)


@pytest.mark.parametrize("kw", [
    dict(isolvar=-1), dict(isolvar=-1, scon=1361.0),
    dict(isolvar=-1, scon=1361.0, bndscl=np.linspace(0.9, 1.1, 14)),
    dict(isolvar=0), dict(isolvar=0, scon=1361.0),
    dict(isolvar=1, solcycfrac=0.3),
    dict(isolvar=1, solcycfrac=0.01, scon=1361.0, indsolvar=(1.2, 0.9)),
    dict(isolvar=1, solcycfrac=0.8, indsolvar=(1.1, 1.0)),
    dict(isolvar=2, scon=1361.0, indsolvar=(0.16, 1000.0)),
    dict(isolvar=3, scon=1361.0, bndscl=np.linspace(1.1, 0.9, 14))],
    ids=str)
def test_nrlssi2_copy(kw):
    a = nrlssi2.solar_source_weights(**kw)
    b = ref_nrlssi2.solar_source_weights(**kw)
    assert a._fields == b._fields
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for k, v in _public(ref_nrlssi2).items():
        assert getattr(nrlssi2, k) == v, k
    for f in (0.0, 0.003, 0.25, 0.999, 1.0):
        assert nrlssi2.interpolate_indices(f) == \
            ref_nrlssi2.interpolate_indices(f)


def _body(mod):
    """A module's source below its docstring."""
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]


@pytest.mark.parametrize("port,ref", [(clock, ref_clock),
                                      (solar_cycle, ref_solar_cycle)],
                         ids=["clock", "solar_cycle"])
def test_plain_python_copy_source(port, ref):
    """clock.py and solar_cycle.py are the reference's modules below the
    docstring, line for line."""
    assert _body(port) == _body(ref)


def test_clock_and_solar_cycle_copies_behave_alike():
    kw = dict(run_dt=900.0, solar_dt=2700.0, called_last=True,
              start_doy=31.5, start_utc_hours=22.0)
    a, b = clock.RadiationClock(**kw), ref_clock.RadiationClock(**kw)
    for _ in range(7):
        assert (a.tick(), a.utc_hours, a.doy) == (b.tick(), b.utc_hours,
                                                  b.doy)
    assert a.state_dict() == b.state_dict()
    days = np.array([738000, 738001, 738004])
    arrays = dict(days=days, tsi=np.array([1360.0, 1361.5, 1359.0]),
                  mg=np.array([0.15, 0.16, 0.155]),
                  sb=np.array([800.0, 900.0, 850.0]))
    x = solar_cycle.SolarCycleData(**arrays)
    y = ref_solar_cycle.SolarCycleData(**arrays)
    for doy in (1.0, 200.25, 201.5, 202.9, 204.0, 300.0):
        assert x.at_doy(2021, doy) == y.at_doy(2021, doy)


CONSTRUCTORS = {
    "example_inputs": lambda: example_inputs(4),
    "RRTMGLW.from_reference_tables": lw.RRTMGLW.from_reference_tables,
    "RRTMGSW.from_reference_tables": sw.RRTMGSW.from_reference_tables,
    "lw_planck_tables": lw.lw_planck_tables,
    "lw_cloud_tables": cldprmc_lw.lw_cloud_tables,
    "sw_cloud_tables": cldprmc_sw.sw_cloud_tables,
    "taumol_sw.taumol_tables": taumol_sw.taumol_tables,
    "threefry.key": threefry.key,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    """With no device the constructors build on the card: on a torch
    without CUDA they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        out = CONSTRUCTORS[name]()
        t = out if isinstance(out, torch.Tensor) else next(
            v for v in (out.buffers() if hasattr(out, "buffers") else
                        out.values() if isinstance(out, dict) else out)
            if isinstance(v, torch.Tensor))
        assert t.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        CONSTRUCTORS[name]()
