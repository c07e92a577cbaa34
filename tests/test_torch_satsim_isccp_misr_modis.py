"""The port's ISCCP (icarus), MISR and MODIS simulators against the JAX
CPU oracle, and the oracle's own physics tests of them run on the port.

Parity on seeded multi-layer scenes of 8 points x 40 levels with 50
subcolumns from the oracle's scops, half the points sunlit: every output
of isccp_simulator (each top_height and top_height_direction),
misr_simulator, modis_l2_simulator and modis_l3_simulator within 5e-5
relmax (tools/verify_tpu.py:33-36) where the oracle's value is not a fill
value, the fill values (MISSING, R_UNDEF, RE_FILL) in exactly the same
places, phases exact, and every histogram cell and cloud fraction, as a
count of subcolumns, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu import satsim as js
from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.satsim import (isccp_simulator,
                                                     misr_simulator,
                                                     modis_l2_simulator,
                                                     modis_l3_simulator,
                                                     scops)
from geosradiation_gridcomp_tpu_torch.satsim.modis import (PHASE_ICE,
                                                           PHASE_LIQ,
                                                           PHASE_NONE,
                                                           R_UNDEF)
from tests.test_torch_satsim_scops_stats import compare, t

torch.set_num_threads(1)

NPNT, NLEV, NCOL = 8, 40, 50


@pytest.fixture(scope="module")
def scene():
    """Three cloud decks with random fraction, optical depth and
    emissivity on a stretched pressure grid; subcolumns from the oracle's
    scops; points 0-3 sunlit."""
    rng = np.random.default_rng(7)
    a = np.linspace(0.02, 1.0, NLEV + 1) ** 1.3
    phalf = np.tile(1e5 * a, (NPNT, 1)).astype(np.float32)
    phalf[:, 0] = 100.0
    pfull = (0.5 * (phalf[:, 1:] + phalf[:, :-1])).astype(np.float32)
    ts = rng.uniform(285.0, 300.0, NPNT).astype(np.float32)
    at = np.maximum(ts[:, None] * (pfull / phalf[:, -1:]) ** 0.22,
                    205.0).astype(np.float32)
    qv = (0.01 * (pfull / pfull[:, -1:]) ** 3).astype(np.float32)
    cc = np.zeros((NPNT, NLEV), np.float32)
    dtau = np.zeros_like(cc)
    for k0, k1, tmax in ((12, 15, 3.0), (22, 25, 12.0), (32, 36, 40.0)):
        cc[:, k0:k1] = rng.uniform(0.1, 0.9, (NPNT, k1 - k0))
        dtau[:, k0:k1] = rng.uniform(0.05, tmax, (NPNT, k1 - k0))
    dem = (1.0 - np.exp(-dtau / 2.13)).astype(np.float32)
    frac = np.asarray(js.scops(jax.random.PRNGKey(5), jnp.asarray(cc),
                               jnp.zeros((NPNT, NLEV)), NCOL))
    z = (-7500.0 * np.log(pfull / phalf[:, -1:])).astype(np.float32)
    sunlit = (np.arange(NPNT) < NPNT // 2).astype(np.int32)
    return dict(pfull=pfull, phalf=phalf, qv=qv, at=at, ts=ts, dtau=dtau,
                dem=dem, frac=frac, zfull=z, sunlit=sunlit)


def _isccp_args(sc, framework):
    z = np.zeros_like(sc["dtau"])
    args = (sc["frac"], sc["pfull"], sc["phalf"], sc["qv"], sc["at"],
            sc["ts"], 0.99, sc["dtau"], z, sc["dem"], z, sc["sunlit"])
    conv = jnp.asarray if framework == "jax" else t
    return tuple(a if isinstance(a, float) else conv(a) for a in args)


@pytest.mark.parametrize("top_height,direction",
                         [(1, 2), (1, 1), (2, 2), (3, 2), (3, 1)])
def test_isccp_matches_oracle(scene, top_height, direction):
    kw = dict(top_height=top_height, top_height_direction=direction)
    want = js.isccp_simulator(*_isccp_args(scene, "jax"), **kw)
    got = isccp_simulator(*_isccp_args(scene, "torch"), **kw)
    compare(got, jax.tree_util.tree_map(np.asarray, want), "isccp", NCOL)
    # the scene reaches the histogram's cells and both masks
    fq = np.asarray(want["fq_isccp"])[:NPNT // 2]
    assert (fq > 0).sum() >= 4


def test_misr_matches_oracle(scene):
    z = np.zeros_like(scene["dtau"])
    args = (scene["frac"], scene["zfull"], scene["at"], scene["dtau"], z,
            scene["sunlit"])
    want = js.misr_simulator(*(jnp.asarray(a) for a in args))
    got = misr_simulator(*(t(a) for a in args))
    compare(got, jax.tree_util.tree_map(np.asarray, want), "misr", NCOL)
    ztop = np.asarray(want["box_misr_ztop"])
    assert (ztop > 0).any() and (ztop == 0).any()


@pytest.fixture(scope="module")
def modis_inputs(scene):
    """Per-subcolumn liquid and ice optical depths split by a random
    liquid fraction, random sizes; the ISCCP tau and ctp of the oracle."""
    rng = np.random.default_rng(9)
    cloudy = scene["frac"] == 1
    tau = np.where(cloudy, scene["dtau"][:, None, :], 0.0)
    lf = rng.choice([0.0, 0.5, 1.0], (NPNT, NCOL, 1))
    isccp = js.isccp_simulator(*_isccp_args(scene, "jax"))
    shape = (NPNT, NCOL, NLEV)
    return tuple(np.asarray(a, np.float32) for a in (
        scene["at"], scene["pfull"], scene["phalf"], tau * lf,
        tau * (1.0 - lf), rng.uniform(4.0, 25.0, shape),
        rng.uniform(10.0, 80.0, shape), isccp["boxtau"], isccp["boxptop"]))


def test_modis_l2_l3_match_oracle(modis_inputs):
    want2 = js.modis_l2_simulator(*(jnp.asarray(a) for a in modis_inputs))
    got2 = modis_l2_simulator(*(t(a) for a in modis_inputs))
    compare(got2, jax.tree_util.tree_map(np.asarray, want2), "l2", NCOL)
    phases = set(np.unique(np.asarray(want2["phase"])))
    assert phases == {PHASE_NONE, PHASE_LIQ, PHASE_ICE, 3}, phases
    want3 = js.modis_l3_simulator(want2["phase"], want2["ctp"],
                                  want2["tau"], want2["size"])
    got3 = modis_l3_simulator(*(t(np.asarray(want2[k])) for k in
                                ("phase", "ctp", "tau", "size")))
    compare(got3, jax.tree_util.tree_map(np.asarray, want3), "l3", NCOL)


# ---------------------------------------------------------------------------
# the oracle's physics tests (tests/test_satsim_scops_isccp.py and
# tests/test_satsim_misr_modis.py), on the port
# ---------------------------------------------------------------------------

def _isccp_inputs(npoints=8, nlev=30, tau_cld=10.0, p_cld=30000.0,
                  cldfrac=1.0, em_cld=0.99):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.3
    phalf = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    phalf[:, 0] = 100.0
    pfull = 0.5 * (phalf[:, 1:] + phalf[:, :-1])
    ts = np.full((npoints,), 295.0, np.float32)
    at = np.maximum(ts[:, None] * (pfull / phalf[:, -1:]) ** 0.22,
                    205.0).astype(np.float32)
    qv = (0.01 * (pfull / pfull[:, -1:]) ** 3).astype(np.float32)
    k_cld = int(np.argmin(abs(pfull[0] - p_cld)))
    cc = np.zeros_like(pfull)
    cc[:, k_cld] = cldfrac
    dtau = np.zeros_like(pfull)
    dtau[:, k_cld] = tau_cld
    dem = np.zeros_like(pfull)
    dem[:, k_cld] = em_cld
    return dict(pfull=t(pfull), phalf=t(phalf), qv=t(qv), at=t(at),
                skt=t(ts), cc=t(cc), dtau=t(dtau), dem=t(dem), k_cld=k_cld)


def _run_isccp(inp, ncol=50, top_height=1, sunlit=1):
    npoints, nlev = inp["pfull"].shape
    frac = scops(threefry.key(7, device="cpu"), inp["cc"],
                 torch.zeros(npoints, nlev), ncol, overlap=3)
    z = torch.zeros_like(inp["dtau"])
    return isccp_simulator(
        frac, inp["pfull"], inp["phalf"], inp["qv"], inp["at"], inp["skt"],
        0.99, inp["dtau"], z, inp["dem"], z,
        torch.full((npoints,), sunlit, dtype=torch.int32),
        top_height=top_height)


def _isccp_overcast_thick_cloud_bins_correctly():
    out = _run_isccp(_isccp_inputs(tau_cld=15.0, p_cld=30000.0))
    np.testing.assert_allclose(out["totalcldarea"].numpy(), 1.0, atol=1e-5)
    fq = out["fq_isccp"].numpy()
    np.testing.assert_allclose(fq.sum((1, 2)), 1.0, atol=1e-5)
    assert fq[:, 4, :].sum(-1).min() > 0.999
    assert (fq[:, 4, 1] + fq[:, 4, 2]).min() > 0.999


def _isccp_mean_properties_physical():
    out = _run_isccp(_isccp_inputs(tau_cld=15.0, p_cld=30000.0))
    np.testing.assert_allclose(out["meantaucld"].numpy(), 15.0, rtol=0.05)
    ptop = out["meanptop"].numpy()
    assert ((ptop > 150.0) & (ptop < 450.0)).all()
    tbclr, tb = out["meantbclr"].numpy(), out["meantb"].numpy()
    assert ((tbclr > 250.0) & (tbclr < 300.0)).all()
    assert (tb < tbclr - 10.0).all(), "cold cloud lowers Tb"


def _isccp_clear_sky_zero_area():
    out = _run_isccp(_isccp_inputs(cldfrac=0.0, tau_cld=0.0, em_cld=0.0))
    assert np.allclose(out["totalcldarea"].numpy(), 0.0)
    assert np.allclose(out["fq_isccp"].numpy().sum((1, 2)), 0.0)
    assert np.allclose(out["meantaucld"].numpy(), -1e30)


def _isccp_partial_cloud_area_matches_fraction():
    out = _run_isccp(_isccp_inputs(npoints=64, cldfrac=0.45, tau_cld=8.0),
                     ncol=200)
    area = out["totalcldarea"].numpy()
    np.testing.assert_allclose(area.mean(), 0.45, atol=0.01)
    assert (np.abs(area - 0.45) < 0.15).all()


def _isccp_model_ptop_mode():
    inp = _isccp_inputs(tau_cld=15.0, p_cld=30000.0)
    out = _run_isccp(inp, top_height=2)
    expect = float(inp["phalf"][0, inp["k_cld"]]) / 100.0
    np.testing.assert_allclose(out["meanptop"].numpy(), expect, rtol=1e-3)


def _isccp_night_masked_unless_ir_only():
    inp = _isccp_inputs()
    assert np.allclose(_run_isccp(inp, sunlit=0)["totalcldarea"].numpy(),
                       -1e30)
    out3 = _run_isccp(inp, top_height=3, sunlit=0)
    assert out3["totalcldarea"].numpy().min() > 0.99


def _misr_scene(npoints=6, nlev=24, ncol=20, z_cld=3000.0, tau=8.0):
    z = np.linspace(18000.0, 200.0, nlev)
    zfull = np.tile(z, (npoints, 1)).astype(np.float32)
    at = np.maximum((288.0 - 6.5e-3 * z)[None, :].repeat(npoints, 0),
                    210.0).astype(np.float32)
    k = int(np.argmin(abs(z - z_cld)))
    dtau = np.zeros((npoints, nlev), np.float32)
    dtau[:, k] = tau
    frac = np.zeros((npoints, ncol, nlev), np.int8)
    frac[:, :, k] = 1
    return dict(zfull=t(zfull), at=t(at), dtau=t(dtau), frac=t(frac))


def _run_misr(sc, frac=None, sunlit=1):
    return misr_simulator(sc["frac"] if frac is None else frac, sc["zfull"],
                          sc["at"], sc["dtau"], torch.zeros_like(sc["dtau"]),
                          torch.full((6,), sunlit, dtype=torch.int32))


def _misr_cth_bin_matches_cloud_height():
    out = _run_misr(_misr_scene(z_cld=3000.0, tau=8.0))
    fq = out["fq_misr"].numpy()
    np.testing.assert_allclose(fq.sum((1, 2)), 1.0, atol=1e-5)
    assert fq[:, 3, :].sum(-1).min() > 0.999
    assert 2000.0 <= float(out["mean_ztop"][0]) <= 4000.0
    assert fq[0, 3, :].argmax() in (7, 8)


def _misr_thin_cloud_no_height():
    out = _run_misr(_misr_scene(tau=0.25))
    assert (out["box_misr_ztop"].numpy() == -1.0).all()
    assert out["fq_misr"].numpy()[:, :, 0].sum(-1).min() > 0.999


def _misr_clear_sky():
    sc = _misr_scene(tau=0.0)
    out = _run_misr(sc, frac=torch.zeros_like(sc["frac"]))
    assert np.allclose(out["cldarea"].numpy(), 0.0)


def _misr_night_masked():
    out = _run_misr(_misr_scene(), sunlit=0)
    assert (out["cldarea"].numpy() == -1e30).all()


def _modis_scene(npoints=4, nlev=24, ncol=16, tau=10.0, phase="liq",
                 p_cld=30000.0):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.2
    plev = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    plev[:, 0] = 50.0
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    temp = np.maximum(288.0 * (play / play[:, -1:]) ** 0.22,
                      210.0).astype(np.float32)
    k = int(np.argmin(abs(play[0] - p_cld)))
    shape = (npoints, ncol, nlev)
    tl = np.zeros(shape, np.float32)
    ti = np.zeros(shape, np.float32)
    if phase == "liq":
        tl[:, :, k] = tau
    elif phase == "ice":
        ti[:, :, k] = tau
    else:
        tl[:, :, k] = tau / 2
        ti[:, :, k] = tau / 2
    args = (temp, play.astype(np.float32), plev, tl, ti,
            np.full(shape, 12.0, np.float32), np.full(shape, 40.0, np.float32),
            np.full((npoints, ncol), tau, np.float32),
            np.full((npoints, ncol), p_cld / 100.0, np.float32))
    return tuple(t(x) for x in args), k, plev


def _modis_phase_discrimination():
    for phase, want in (("liq", PHASE_LIQ), ("ice", PHASE_ICE)):
        out = modis_l2_simulator(*_modis_scene(phase=phase)[0])
        assert (out["phase"].numpy() == want).all(), phase


def _modis_tau_and_ctp():
    args, k, plev = _modis_scene(tau=10.0, p_cld=30000.0)
    out = modis_l2_simulator(*args)
    np.testing.assert_allclose(out["tau"].numpy(), 10.0, rtol=1e-5)
    ctp = out["ctp"].numpy()
    assert (ctp > plev[0, k]).all() and (ctp < plev[0, k + 1]).all()


def _modis_low_cloud_uses_isccp_ctp():
    out = modis_l2_simulator(*_modis_scene(tau=10.0, p_cld=85000.0)[0])
    np.testing.assert_allclose(out["ctp"].numpy(), 85000.0, rtol=1e-4)


def _modis_size_retrieval_recovers_input():
    out = modis_l2_simulator(*_modis_scene(tau=20.0, phase="liq")[0])
    np.testing.assert_allclose(out["size"].numpy() * 1e6, 12.0, atol=1.5)
    out = modis_l2_simulator(*_modis_scene(tau=20.0, phase="ice")[0])
    np.testing.assert_allclose(out["size"].numpy() * 1e6, 40.0, atol=5.0)


def _modis_subvisible_cloud_is_none():
    out = modis_l2_simulator(*_modis_scene(tau=0.1)[0])
    assert (out["phase"].numpy() == PHASE_NONE).all()
    assert (out["tau"].numpy() == R_UNDEF).all()


def _modis_l3_aggregation():
    l2 = modis_l2_simulator(*_modis_scene(npoints=3, ncol=16, tau=10.0)[0])
    phase = l2["phase"].clone()
    phase[:, 8:] = PHASE_NONE
    size = l2["size"].clone()
    size[:, 8:] = R_UNDEF
    l3 = modis_l3_simulator(phase, l2["ctp"], l2["tau"], size)
    np.testing.assert_allclose(l3["cf_total"].numpy(), 0.5)
    np.testing.assert_allclose(l3["cf_water"].numpy(), 0.5)
    np.testing.assert_allclose(l3["cf_ice"].numpy(), 0.0)
    np.testing.assert_allclose(l3["tau_water_mean"].numpy(), 10.0,
                               rtol=1e-5)
    np.testing.assert_allclose(l3["cf_high"].numpy(), 0.5)
    np.testing.assert_allclose(l3["tau_vs_ctp"].numpy().sum((1, 2)), 0.5,
                               atol=1e-6)


PHYSICS = {f.__name__[1:]: f for f in (
    _isccp_overcast_thick_cloud_bins_correctly,
    _isccp_mean_properties_physical, _isccp_clear_sky_zero_area,
    _isccp_partial_cloud_area_matches_fraction, _isccp_model_ptop_mode,
    _isccp_night_masked_unless_ir_only, _misr_cth_bin_matches_cloud_height,
    _misr_thin_cloud_no_height, _misr_clear_sky, _misr_night_masked,
    _modis_phase_discrimination, _modis_tau_and_ctp,
    _modis_low_cloud_uses_isccp_ctp, _modis_size_retrieval_recovers_input,
    _modis_subvisible_cloud_is_none, _modis_l3_aggregation)}


@pytest.mark.parametrize("case", sorted(PHYSICS))
def test_reference_physics_on_the_port(case):
    PHYSICS[case]()
