"""The port's native RRTMGP engine (models/rrtmgp/gas_optics.py,
rte_native.py and the native k-distribution classes) against the JAX CPU
oracle, on the synthetic k-distributions of tests/test_rrtmgp_engine.py
(no real coefficient file is in the repo) at 8 columns x 72 layers.

Gates (relmax = max|a-b| / max|b|): every optical depth, source and flux
<= 5e-5; on the constant-k set both sides equal the exact col_mix * k
limit within 2e-5 (the oracle's own test, tests/test_rrtmgp_engine.py:98);
load_kdist_npz carries every table and every metadata field across
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.models.rrtmgp import gas_optics as jgo
from geosradiation_gridcomp_tpu.models.rrtmgp import kdist as jkd
from geosradiation_gridcomp_tpu.models.rrtmgp import rte_native as jrn
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import gas_concs as tgc
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import gas_optics as tgo
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import kdist as tkd
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import rte_native as trn
from chip_smoke import save_kdist_npz, synthetic_kdist
from tests.test_rrtmgp_driver import _save_kdist_npz
from tests.test_rrtmgp_engine import NBND, NGPT, make_atmos, make_kdist

torch.set_num_threads(1)

NCOL, NLAY = 8, 72


def relmax(a, b, floor=1e-30):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def _t(x):
    return torch.as_tensor(np.array(x))


def _minor(kminor, lims, gas, swd, sgas, sbc):
    return dict(kminor=kminor, gpt_limits=np.asarray(lims, np.int64),
                gas_idx=np.asarray(gas, np.int64),
                scales_with_density=np.asarray(swd),
                scaling_gas=np.asarray(sgas, np.int64),
                scale_by_complement=np.asarray(sbc))


def kdist_set(name):
    """The synthetic sets: smooth tables with one lower minor contributor
    ("smooth"); constant kmajor, no minor ("constant", the exact
    col_mix * k limit); and minor contributors in both regimes whose
    ranges straddle the two flavors, scaled by density, by a scaling gas
    and by its complement ("minors")."""
    if name == "constant":
        data = make_kdist(constant_k=3e-22)
        data["minor_lower"] = None
        return data
    data = make_kdist()
    if name == "minors":
        rng = np.random.default_rng(7)
        k = lambda n: (1e-21 * (1.0 + rng.random((5, 9, n)))).astype(
            np.float32)
        data["minor_lower"] = _minor(k(7), [[3, 5], [7, 10]], [3, 2],
                                     [True, False], [1, 0], [False, False])
        data["minor_upper"] = _minor(k(9), [[6, 11], [13, 15]], [2, 3],
                                     [True, True], [1, 1], [True, False])
    return data


SETS = ("smooth", "constant", "minors")


@pytest.fixture(scope="module")
def atmos():
    play, tlay, plev, tlev, tsfc, vmrs = make_atmos(ncol=NCOL, nlay=NLAY)
    j = (play, tlay, plev, tlev, tsfc, vmrs)
    t = tuple(_t(x) for x in j[:5]) + ({k: _t(v) for k, v in vmrs.items()},)
    return j, t


@pytest.mark.parametrize("name", SETS)
def test_gas_optics_lw(atmos, name):
    data = kdist_set(name)
    (j, t) = atmos
    taug_j, src_j = jgo.gas_optics_lw(data, *j)
    taug_t, src_t = tgo.gas_optics_lw(tkd.load_kdist_npz(data, "cpu"), *t)
    assert tuple(taug_t.shape) == taug_j.shape == (NCOL, NLAY, NGPT)
    assert relmax(taug_t.numpy(), taug_j) <= 5e-5
    assert set(src_t) == set(src_j)
    for k in src_j:
        assert tuple(src_t[k].shape) == src_j[k].shape, k
        assert relmax(src_t[k].numpy(), src_j[k]) <= 5e-5, k


@pytest.mark.parametrize("name", SETS)
def test_gas_optics_sw(atmos, name):
    data = kdist_set(name)
    (j, t) = atmos
    out_j = jgo.gas_optics_sw(data, j[0], j[1], j[2], j[5])
    out_t = tgo.gas_optics_sw(tkd.load_kdist_npz(data, "cpu"), t[0], t[1],
                              t[2], t[5])
    for a, b in zip(out_t, out_j):
        assert tuple(a.shape) == b.shape
        assert relmax(a.numpy(), b) <= 5e-5


def test_minor_contributors_change_taug(atmos):
    """The "minors" set's contributors reach taug in both regimes (so the
    comparison above exercises them)."""
    (_, t) = atmos
    taug = tgo.gas_optics_lw(tkd.load_kdist_npz(kdist_set("minors"), "cpu"),
                             *t)[0]
    data0 = kdist_set("minors")
    data0["minor_lower"] = data0["minor_upper"] = None
    taug0 = tgo.gas_optics_lw(tkd.load_kdist_npz(data0, "cpu"), *t)[0]
    changed = (taug != taug0).any(dim=(0, 1))
    assert changed.tolist() == [g in {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13,
                                      14} for g in range(NGPT)]


def test_constant_k_exact_limit(atmos):
    """kmajor == k0 everywhere: tau = (col_gas1 + ratio col_gas2) k0 per
    flavor, band 1 (h2o, co2; ratio 20) and band 2 (o3, dry; 5e-6)."""
    (j, t) = atmos
    k0 = 3e-22
    taug = tgo.gas_optics_lw(tkd.load_kdist_npz(kdist_set("constant"),
                                                "cpu"), *t)[0].double()
    h2o, o3 = (t[5][g].double() for g in ("h2o", "o3"))
    _, col_dry = tgo.column_gas(t[2].double(), torch.ones_like(h2o), h2o)
    want1 = col_dry * (h2o + 20.0 * 4.1e-4) * k0
    want2 = (col_dry * o3 + 5e-6 * col_dry) * k0
    assert float(((taug[..., 0] - want1).abs() / want1).max()) < 2e-5
    assert float(((taug[..., 12] - want2).abs() / want2).max()) < 2e-5


def _lw_inputs(atmos, name, rng):
    """The oracle's LW gas optics of a set, and a cloud optical depth."""
    (j, _) = atmos
    taug, src = jgo.gas_optics_lw(kdist_set(name), *j)
    tau_cld = (rng.random((NCOL, NLAY, NGPT)) * (rng.random(
        (NCOL, NLAY, 1)) < 0.2) * 3.0).astype(np.float32)
    emis = rng.uniform(0.85, 1.0, (NCOL, NBND)).astype(np.float32)
    return taug, src, tau_cld, emis


@pytest.mark.parametrize("dudts", [False, True])
@pytest.mark.parametrize("clouds", [False, True])
@pytest.mark.parametrize("name", ("smooth", "constant"))
def test_rte_lw_native(atmos, name, clouds, dudts):
    rng = np.random.default_rng(11)
    taug, src, tau_cld, emis = _lw_inputs(atmos, name, rng)
    lims = np.array([[1, 8], [9, 16]], np.int64)
    kw = dict(dudts=dudts)
    b = jrn.rte_lw_native(taug, src, jnp.asarray(emis), lims,
                          tau_cld=jnp.asarray(tau_cld) if clouds else None,
                          **kw)
    a = trn.rte_lw_native(_t(taug), {k: _t(v) for k, v in src.items()},
                          _t(emis), lims,
                          tau_cld=_t(tau_cld) if clouds else None, **kw)
    assert set(a) == set(b)
    for k in b:
        assert tuple(a[k].shape) == b[k].shape, k
        assert relmax(a[k].numpy(), b[k]) <= 5e-5, k


@pytest.mark.parametrize("aerosol", [False, True])
@pytest.mark.parametrize("clouds", [False, True])
def test_rte_sw_native(atmos, clouds, aerosol):
    (j, _) = atmos
    taug, taur, src = jgo.gas_optics_sw(kdist_set("smooth"), j[0], j[1],
                                        j[2], j[5])
    rng = np.random.default_rng(13)
    mu0 = np.linspace(-0.2, 0.95, NCOL).astype(np.float32)
    alb = [rng.uniform(0.05, 0.4, (NCOL, NBND)).astype(np.float32)
           for _ in range(2)]
    kw = {}
    if clouds:
        cloudy = rng.random((NCOL, NLAY, 1)) < 0.2
        kw.update(tau_cld=(rng.random((NCOL, NLAY, NGPT)) * 5.0 * cloudy),
                  ssa_cld=rng.uniform(0.9, 0.9999, (NCOL, NLAY, NGPT)),
                  g_cld=rng.uniform(0.7, 0.9, (NCOL, NLAY, NGPT)))
    if aerosol:
        kw.update(tau_aer=rng.uniform(0.0, 0.05, (NCOL, NLAY, NBND)),
                  ssa_aer=rng.uniform(0.8, 1.0, (NCOL, NLAY, NBND)),
                  g_aer=rng.uniform(0.5, 0.8, (NCOL, NLAY, NBND)))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    lims = np.array([[1, 8], [9, 16]], np.int64)
    b = jrn.rte_sw_native(taug, taur, src, jnp.asarray(mu0),
                          *(jnp.asarray(x) for x in alb), lims,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    a = trn.rte_sw_native(_t(taug), _t(taur), _t(src), _t(mu0),
                          *(_t(x) for x in alb), lims,
                          **{k: _t(v) for k, v in kw.items()})
    assert set(a) == set(b)
    for k in b:
        assert tuple(a[k].shape) == b[k].shape, k
        assert relmax(a[k].numpy(), b[k]) <= 5e-5, k
    night = torch.as_tensor(mu0 <= 0.0)
    assert float(a["flux_dn"][night].abs().max()) == 0.0


def test_native_isothermal_opaque_column(atmos):
    """KDistLWNative -> rte_lw_native on an isothermal opaque column:
    every upward flux equals the band-summed Planck source, as in the
    oracle's test (tests/test_rrtmgp_engine.py:241)."""
    (_, t) = atmos
    play, tlay, plev, tlev, tsfc, vmrs = t
    kd = tkd.KDistLWNative(make_kdist(constant_k=5e-18), device="cpu")
    t0 = 260.0
    gas = tgc.GasConcs()
    for nm, v in vmrs.items():
        gas.set_vmr(nm, v)
    emis = torch.ones(NCOL, NBND)
    taug, src = kd.gas_optics(play * 0.01, torch.full_like(tlay, t0),
                              plev * 0.01, torch.full_like(tlev, t0),
                              torch.full_like(tsfc, t0), emis, gas)
    out = trn.rte_lw_native(taug, src, emis, kd.get_band_lims_gpoint())
    b_tot = 10.0 + (t0 - 160.0) / 180.0 * 50.0
    assert float((out["uflx"] - b_tot).abs().max()) < 1e-2 * b_tot
    assert float(out["dflx"][:, 0].abs().max()) == 0.0
    assert float((out["olrb"][:, 0] / b_tot - 0.6).abs().max()) < 1e-2


def test_load_kdist_npz(tmp_path):
    """From an npz of the ingest schema and from the dict form alike:
    tables as float32 tensors on the device, metadata as the oracle's
    loader gives it."""
    data = kdist_set("minors")
    path = str(tmp_path / "k.npz")
    _save_kdist_npz(data, path)
    ref = jkd.load_kdist_npz(path)
    for src in (path, data):
        got = tkd.load_kdist_npz(src, "cpu")
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k in ("minor_lower", "minor_upper"):
                assert set(got[k]) == set(v)
                for kk, vv in v.items():
                    np.testing.assert_array_equal(np.asarray(got[k][kk]), vv)
                assert got[k]["kminor"].dtype == torch.float32
            elif k in tkd.TABLE_KEYS:
                assert isinstance(got[k], torch.Tensor)
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(v, np.float32))
            else:
                np.testing.assert_array_equal(np.asarray(got[k]), v)
    for jcls, tcls in ((jkd.KDistLWNative, tkd.KDistLWNative),
                       (jkd.KDistSWNative, tkd.KDistSWNative)):
        j, t = jcls(path), tcls(path, device="cpu")
        for name in ("source_is_external", "get_ngpt", "get_nband") + (
                ("get_press_min", "get_temp_min")
                if jcls is jkd.KDistLWNative else ()):
            assert getattr(t, name)() == getattr(j, name)(), name
        for name in ("get_band_lims_wavenumber", "get_band_lims_gpoint"):
            np.testing.assert_array_equal(getattr(t, name)(),
                                          getattr(j, name)())


def test_chip_smoke_copy_of_the_synthetic_set(tmp_path):
    """chip_smoke.py's numpy copies (it may not import tests/, which
    imports jax) equal make_kdist() and the npz the driver test writes."""
    a, b = synthetic_kdist(), make_kdist()
    assert set(a) == set(b)
    for k in b:
        if k == "minor_lower":
            assert set(a[k]) == set(b[k])
            for kk in b[k]:
                np.testing.assert_array_equal(a[k][kk], b[k][kk])
                assert a[k][kk].dtype == b[k][kk].dtype
        elif b[k] is None:
            assert a[k] is None
        else:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    save_kdist_npz(a, tmp_path / "a.npz")
    _save_kdist_npz(b, tmp_path / "b.npz")
    with np.load(tmp_path / "a.npz") as fa, np.load(tmp_path / "b.npz") as fb:
        assert set(fa.files) == set(fb.files)
        for k in fb.files:
            np.testing.assert_array_equal(fa[k], fb[k])
