"""The port's COSP driver (cosp_simulator) against the JAX CPU oracle end
to end, group by group, and the oracle's own driver tests run on the
port.

Parity on the oracle's synthetic scene (tests/test_satsim_cosp.py: 8
points x 40 levels, a liquid deck at 750 hPa with rain below it, an ice
deck at 300 hPa), key 11 (threefry.key(11) = jax.random.PRNGKey(11)):
frac_out exact; every float field of every group (isccp, misr, modis and
its l2, lidar, radar) within 5e-5 relmax (tools/verify_tpu.py:33-36)
where the oracle's value is not a fill value, the fill values in exactly
the same places, phases exact, every histogram cell and cloud fraction,
as a count of subcolumns, exact. Under SatsimConfig() (50 subcolumns,
every simulator, the 40-bin CloudSat stat grid), on the model grid
(use_vgrid=False), with the model cloud top (isccp_top_height=2), and
with half the points at night.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu import satsim as js
from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.satsim import (SatsimConfig,
                                                     SatsimInputs,
                                                     cosp_simulator)
from geosradiation_gridcomp_tpu_torch.satsim.cosp import (
    _chou_ir_tau_band4, _chou_vis_tau, _distribute, _qsat)
from geosradiation_gridcomp_tpu_torch.satsim.radar import \
    lidar_only_freq_cloud

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tests.test_satsim_cosp import scene as j_scene  # noqa: E402
from tests.test_torch_satsim_scops_stats import compare, t  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    inp, k_liq, k_ice = j_scene.__wrapped__()
    return inp, k_liq, k_ice


def port_inputs(inp):
    return SatsimInputs(*(t(np.asarray(x)) for x in inp))


CONFIGS = {
    "default": {},
    "model_grid": dict(use_vgrid=False),
    "model_ptop": dict(isccp_top_height=2, ncolumns=20),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cosp_matches_oracle(scene, name):
    inp = scene[0]
    kw = CONFIGS[name]
    want = js.cosp_simulator(jax.random.PRNGKey(11), inp,
                             js.SatsimConfig(**kw))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = cosp_simulator(threefry.key(11, device="cpu"), port_inputs(inp),
                         SatsimConfig(**kw))
    assert set(got) == {"frac_out", "isccp", "misr", "modis", "lidar",
                        "radar"}
    ncol = SatsimConfig(**kw).ncolumns
    for group in want:
        compare(got[group], want[group], group, ncol)


def test_cosp_night_points_match_oracle(scene):
    inp = scene[0]
    mcosz = np.asarray(inp.mcosz).copy()
    mcosz[::2] = 0.0
    inp = inp._replace(mcosz=jnp.asarray(mcosz))
    want = jax.tree_util.tree_map(np.asarray, js.cosp_simulator(
        jax.random.PRNGKey(3), inp, js.SatsimConfig(run_lidar=False,
                                                    run_radar=False)))
    got = cosp_simulator(threefry.key(3, device="cpu"), port_inputs(inp),
                         SatsimConfig(run_lidar=False, run_radar=False))
    assert set(got) == set(want)
    for group in want:
        compare(got[group], want[group], group, 50)
    assert (want["isccp"]["totalcldarea"][::2] == -1e30).all()


def test_config_and_inputs_copy_the_oracle():
    """SatsimConfig has the reference's fields and defaults, SatsimInputs
    its fields, in order; the class indices and surface emissivity are
    the reference's."""
    import dataclasses
    from geosradiation_gridcomp_tpu.satsim import cosp as jc
    from geosradiation_gridcomp_tpu_torch.satsim import cosp as tc
    fields = [(f.name, f.default) for f in dataclasses.fields(SatsimConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(js.SatsimConfig)]
    assert SatsimInputs._fields == js.SatsimInputs._fields
    for k in ("I_LSCLIQ", "I_LSCICE", "I_LSRAIN", "I_LSSNOW", "I_CVCLIQ",
              "I_CVCICE", "I_CVRAIN", "I_CVSNOW", "I_LSGRPL", "N_HYDRO",
              "ISCCP_EMSFC_LW"):
        assert getattr(tc, k) == getattr(jc, k), k


def test_driver_pieces_match_oracle(scene):
    """The Chou 0.67 um and 10.5 um optical depths, the subcolumn
    distribution and the radar's saturation humidity."""
    from geosradiation_gridcomp_tpu.satsim import cosp as jc
    inp = scene[0]
    rng = np.random.default_rng(2)
    dp = np.diff(np.asarray(inp.ple), axis=1)
    cwc = rng.uniform(0.0, 3e-4, dp.shape + (4,)).astype(np.float32)
    reff = rng.uniform(0.0, 150.0, dp.shape + (4,)).astype(np.float32)
    for f, g in ((_chou_vis_tau, jc._chou_vis_tau),
                 (_chou_ir_tau_band4, jc._chou_ir_tau_band4)):
        want = g(jnp.asarray(dp), jnp.asarray(cwc), jnp.asarray(reff))
        for i, (a, b) in enumerate(zip(f(t(dp), t(cwc), t(reff)), want)):
            compare(a, np.asarray(b), f"{f.__name__}[{i}]")
    mask = rng.random((8, 50, 40)) < 0.4
    frac = mask.mean(axis=1).astype(np.float32)
    q = np.asarray(inp.ql)
    compare(_distribute(t(q), t(mask), t(frac)),
            np.asarray(jc._distribute(jnp.asarray(q), jnp.asarray(mask),
                                      jnp.asarray(frac))), "distribute")
    play = 0.5 * (np.asarray(inp.ple)[:, 1:] + np.asarray(inp.ple)[:, :-1])
    compare(_qsat(t(np.asarray(inp.t)), t(play)),
            np.asarray(jc._qsat(inp.t, jnp.asarray(play))), "qsat")


# ---------------------------------------------------------------------------
# the oracle's driver tests (tests/test_satsim_cosp.py and the stat-grid
# cases of tests/test_satsim_stats.py), on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def result(scene):
    inp, k_liq, k_ice = scene
    out = cosp_simulator(threefry.key(11, device="cpu"), port_inputs(inp),
                         SatsimConfig())
    return out, k_liq, k_ice


def _all_simulator_groups_present(scene, result):
    out, *_ = result
    for k in ("isccp", "misr", "modis", "lidar", "radar", "frac_out"):
        assert k in out, k


def _isccp_total_cloud_consistent_with_input(scene, result):
    out, *_ = result
    area = out["isccp"]["totalcldarea"].numpy()
    assert 0.55 < area.mean() < 0.85, area.mean()


def _misr_detects_both_layers(scene, result):
    out, *_ = result
    assert out["misr"]["fq_misr"].sum() > 0
    assert 0.4 < out["misr"]["cldarea"].numpy().mean() < 0.95


def _modis_cloud_fractions_partition(scene, result):
    m = {k: v.numpy() for k, v in result[0]["modis"].items() if k != "l2"}
    cf = m["cf_total"]
    assert (cf <= 1.0).all() and cf.mean() > 0.3
    assert (m["cf_water"] + m["cf_ice"] <= cf + 1e-6).all()
    assert m["cf_water"].mean() > 0.1


def _lidar_sr_cloud_detected_at_layers(scene, result):
    out = result[0]
    lc = out["lidar"]["lidarcld"].numpy()
    b_liq = int(-7500.0 * np.log(0.75) // 480.0)
    b_ice = int(-7500.0 * np.log(0.30) // 480.0)
    assert lc[:, b_liq:b_liq + 2].max(axis=1).mean() > 0.3
    assert lc[:, b_ice:b_ice + 2].max(axis=1).mean() > 0.1
    np.testing.assert_allclose(out["lidar"]["cfad_sr"].numpy().sum(1), 1.0,
                               atol=1e-5)


def _radar_detects_rain_column(scene, result):
    out, k_liq, _ = result
    assert (out["radar"]["dbze"][:, :, k_liq + 2:] > -35.0).any()
    assert out["radar"]["cfad_dbze"].sum() > 0


def _frac_out_population_matches_fcld(scene, result):
    cover = (result[0]["frac_out"] != 0).double().mean(dim=1).numpy()
    np.testing.assert_allclose(cover.mean(0),
                               np.asarray(scene[0].fcld).mean(0), atol=0.05)


def _night_disables_isccp(scene, result):
    inp = port_inputs(scene[0])
    out = cosp_simulator(
        threefry.key(1, device="cpu"),
        inp._replace(mcosz=torch.zeros_like(inp.mcosz)),
        SatsimConfig(run_modis=False, run_lidar=False, run_radar=False,
                     run_misr=False))
    assert (out["isccp"]["totalcldarea"].numpy() == -1e30).all()


def _cosp_driver_stat_grid_shapes(scene, result):
    inp = port_inputs(scene[0])
    out = cosp_simulator(threefry.key(0, device="cpu"), inp,
                         SatsimConfig(ncolumns=8, nlr=40))
    npnt = inp.t.shape[0]
    assert out["radar"]["cfad_dbze"].shape == (npnt, 15, 40)
    assert out["lidar"]["cfad_sr"].shape == (npnt, 15, 40)
    assert out["radar"]["lidar_only_freq_cloud"].shape == (npnt, 40)
    assert (out["radar"]["cfad_dbze"].sum(dim=1) <= 1.0 + 1e-5).all()


def _stat_grid_undefined_bins_and_scan_direction(scene, result):
    sr_asc = np.array([[[1.0, 0.005, 0.005, 20.0, 0.5]]], np.float32)
    dbze_asc = np.array([[[-1.0e30, -100.0, -100.0, -100.0, -100.0]]],
                        np.float32)
    freq, tcc = lidar_only_freq_cloud(t(sr_asc).flip(-1),
                                      t(dbze_asc).flip(-1))
    freq = freq.flip(-1).numpy()
    assert freq[0].tolist() == [0.0, 0.0, 1.0, 1.0, 0.0]
    freq_wrong, _ = lidar_only_freq_cloud(t(sr_asc), t(dbze_asc))
    assert freq_wrong.numpy()[0].tolist() != freq[0].tolist()
    sr_clear = np.array([[[1.0, 0.5, 0.5, 0.5, 0.5]]], np.float32)
    _, tcc_clear = lidar_only_freq_cloud(t(sr_clear).flip(-1),
                                         t(dbze_asc).flip(-1))
    assert float(tcc_clear[0]) == 0.0


PHYSICS = {f.__name__[1:]: f for f in (
    _all_simulator_groups_present, _isccp_total_cloud_consistent_with_input,
    _misr_detects_both_layers, _modis_cloud_fractions_partition,
    _lidar_sr_cloud_detected_at_layers, _radar_detects_rain_column,
    _frac_out_population_matches_fcld, _night_disables_isccp,
    _cosp_driver_stat_grid_shapes,
    _stat_grid_undefined_bins_and_scan_direction)}


@pytest.mark.parametrize("case", sorted(PHYSICS))
def test_reference_physics_on_the_port(scene, result, case):
    PHYSICS[case](scene, result)
