"""The port's CALIPSO lidar (+ PARASOL, LMD/IPSL statistics) and
QuickBeam CloudSat radar simulators against the JAX CPU oracle, and the
oracle's own physics tests of them run on the port.

Parity, same seeded numpy inputs on both sides (8 points x 40 levels, 50
subcolumns): lidar_simulator (both ice types), parasol and lidar_stats;
quickbeam_simulator with every one of the 9 hydrometeor classes present
(Rayleigh reflectivity on, and the default), radar_cfad and
lidar_only_freq_cloud. Floats within 5e-5 relmax (tools/verify_tpu.py:
33-36) where the oracle's value is not a fill value, the fill values
(UNDEF, MISSING_DBZ) in exactly the same places, CFAD and cloud-fraction
counts exact. The numpy Mie tables, refractive indices and the class
table equal the oracle's exactly.

quickbeam_simulator runs the points in blocks: blocked and unblocked
calls are equal bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.satsim import lidar as jl
from geosradiation_gridcomp_tpu.satsim import radar as jr
from geosradiation_gridcomp_tpu_torch.satsim import lidar as tl
from geosradiation_gridcomp_tpu_torch.satsim import radar as qb
from tests.torch_radar_args import radar_arrays
from tests.test_torch_satsim_scops_stats import compare, t

torch.set_num_threads(1)

NPNT, NLEV, NCOL = 8, 40, 50


def _jax(fn, args, **kw):
    out = fn(*(jnp.asarray(a) for a in args), **kw)
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------------
# lidar
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lidar_args():
    """Random in-cloud condensate of all four species in the subcolumns,
    radii in range, zero and beyond the fits' 70 um."""
    rng = np.random.default_rng(4)
    a = np.linspace(0.02, 1.0, NLEV + 1) ** 1.2
    presf = np.tile(1e5 * a, (NPNT, 1)).astype(np.float32)
    presf[:, 0] = 100.0
    pres = (0.5 * (presf[:, 1:] + presf[:, :-1])).astype(np.float32)
    temp = np.maximum(288.0 * (pres / pres[:, -1:]) ** 0.22,
                      210.0).astype(np.float32)
    shape = (NPNT, NCOL, NLEV)

    def q(p, scale):
        return np.where(rng.random(shape) < p, rng.uniform(0, scale, shape),
                        0.0).astype(np.float32)

    def rad(lo, hi):
        r = rng.uniform(lo, hi, (NPNT, NLEV))
        r[:, ::9] = 0.0
        return r.astype(np.float32)
    return (pres, presf, temp, q(0.2, 4e-4), q(0.2, 5e-5), q(0.05, 2e-4),
            q(0.05, 3e-5), rad(4e-6, 20e-6), rad(10e-6, 90e-6),
            rad(4e-6, 20e-6), rad(10e-6, 90e-6))


@pytest.mark.parametrize("ice_type", [0, 1])
def test_lidar_simulator_matches_oracle(lidar_args, ice_type):
    want = _jax(jl.lidar_simulator, lidar_args, ice_type=ice_type)
    got = tl.lidar_simulator(*(t(a) for a in lidar_args), ice_type=ice_type)
    compare(got, want, "lidar")


def test_lidar_stats_matches_oracle(lidar_args):
    lid = _jax(jl.lidar_simulator, lidar_args)
    land = (np.arange(NPNT) % 2).astype(np.float32)
    args = (lid["pnorm"], lid["pmol"], lid["refl"], land, lidar_args[0])
    want = _jax(jl.lidar_stats, args)
    got = tl.lidar_stats(*(t(a) for a in args))
    compare(got, want, "lidar_stats", NCOL)
    # the scene puts subcolumns in every SR bin but the few above 40
    assert (want["cfad_sr"].sum(axis=(0, 2)) > 0).sum() >= 10


def test_parasol_matches_oracle():
    rng = np.random.default_rng(5)
    tau_l = rng.uniform(-1.0, 120.0, (NPNT, NCOL)).astype(np.float32)
    tau_i = np.where(rng.random((NPNT, NCOL)) < 0.5, 0.0,
                     rng.uniform(0.0, 60.0, (NPNT, NCOL))).astype(np.float32)
    tau_l[0, :7] = jl._PARASOL_TAU        # the table's nodes
    want = np.asarray(jl.parasol(jnp.asarray(tau_l), jnp.asarray(tau_i)))
    compare(tl.parasol(t(tau_l), t(tau_i)), want, "parasol")


# ---------------------------------------------------------------------------
# radar
# ---------------------------------------------------------------------------

def test_mie_tables_and_class_table_equal_the_oracle():
    for a, b in zip(qb.mie_tables(), jr.mie_tables()):
        np.testing.assert_array_equal(a, b)
    ha, hb = qb.hclass(), jr.hclass()
    assert set(ha) == set(hb)
    for k in hb:
        np.testing.assert_array_equal(ha[k], hb[k])
    for tc in (-30.0, 0.0, 25.0):
        assert qb.m_wat(94.0, tc) == jr.m_wat(94.0, tc)
        assert qb.m_ice(94.0, tc) == jr.m_ice(94.0, tc)
    x = np.geomspace(1e-3, 10.0, 20)      # the tables' range of x
    for a, b in zip(qb.mie_qext_qbsca(qb.m_wat(94.0, 10.0), x),
                    jr.mie_qext_qbsca(jr.m_wat(94.0, 10.0), x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(qb.D_GRID_UM, jr.D_GRID_UM)


@pytest.fixture(scope="module")
def radar_args():
    """tests/torch_radar_args.py:radar_arrays at 8 points x 50 subcolumns
    x 40 levels."""
    return radar_arrays(NPNT, NCOL, NLEV)


@pytest.mark.parametrize("do_ray", [False, True])
def test_quickbeam_matches_oracle(radar_args, do_ray):
    want = _jax(jr.quickbeam_simulator, radar_args, do_ray=do_ray)
    got = qb.quickbeam_simulator(*(t(a) for a in radar_args), do_ray=do_ray)
    compare(got, want, "quickbeam")
    dbze = want["dbze"]
    assert (dbze == qb.MISSING_DBZ).any() and (dbze > -20.0).any()


def _plane_budget(points, ncol=NCOL, nlev=NLEV):
    """PLANE_BYTES that makes blocks of the given points."""
    return points * ncol * nlev * qb.ND * 4


@pytest.mark.parametrize("block", [1, 3])
def test_quickbeam_blocked_equals_unblocked(radar_args, monkeypatch, block):
    """Each point is independent and nothing is drawn: running the DSD
    planes in blocks of 1 or 3 points (the last block of 2) gives the
    unblocked call's result bit for bit.

    On the CPU, torch's vectorized pow and its scalar loop over a
    tensor's last (numel mod 32) elements round differently in the last
    bit, so a block whose [points, ncol, nlev, 1] planes end in such a
    tail can differ from the unblocked call there (at 50 x 40 a point
    has 2000 elements). The case takes 8 subcolumns: 320 elements a
    point, no tail in any block. On the card every element is computed
    alike whatever the shape (tests/test_torch_cuda.py holds the blocks
    there at 50 subcolumns)."""
    args = [t(a) for a in radar_args]
    args[4:] = [a[:, :, :8].contiguous() for a in args[4:]]
    monkeypatch.setattr(qb, "PLANE_BYTES", _plane_budget(NPNT, 8))
    whole = qb.quickbeam_simulator(*args, do_ray=True)
    monkeypatch.setattr(qb, "PLANE_BYTES", _plane_budget(block, 8))
    parts = qb.quickbeam_simulator(*args, do_ray=True)
    for k in whole:
        assert torch.equal(parts[k], whole[k]), k


def test_quickbeam_block_size_from_the_plane_budget():
    """The default block holds one [points, ncol, nlev, 85] float32 plane
    within PLANE_BYTES: 8192 x 50 x 72 points take blocks of 877, 10
    blocks."""
    assert qb.PLANE_BYTES // _plane_budget(1, 50, 72) == 877


def test_radar_cfad_and_lidar_only_cloud_match_oracle():
    rng = np.random.default_rng(8)
    shape = (NPNT, NCOL, NLEV)
    dbze = rng.uniform(-110.0, 90.0, shape)
    dbze[rng.random(shape) < 0.3] = qb.MISSING_DBZ
    dbze[0, 0, :15] = np.arange(-50.0, 25.0, 5.0)       # on the bin edges
    dbze = dbze.astype(np.float32)
    want = np.asarray(jr.radar_cfad(jnp.asarray(dbze)))
    compare(qb.radar_cfad(t(dbze)), want, "cfad_dbze", NCOL)
    sr = np.where(rng.random(shape) < 0.2, 0.005,
                  rng.uniform(0.0, 40.0, shape)).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, jr.lidar_only_freq_cloud(
        jnp.asarray(sr), jnp.asarray(dbze)))
    got = qb.lidar_only_freq_cloud(t(sr), t(dbze))
    compare(dict(zip(("lidar_only_freq_cloud", "radar_lidar_tcc"), got)),
            dict(zip(("lidar_only_freq_cloud", "radar_lidar_tcc"), want)),
            "lidar_only", NCOL)


# ---------------------------------------------------------------------------
# the oracle's physics tests (tests/test_satsim_lidar.py and
# tests/test_satsim_radar.py), on the port
# ---------------------------------------------------------------------------

def _atmos(npoints=4, nlev=30, ncol=8, q_liq=0.0, q_ice=0.0,
           p_cld=70000.0, cldcols=None):
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.2
    presf = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    presf[:, 0] = 100.0
    pres = 0.5 * (presf[:, 1:] + presf[:, :-1]).astype(np.float32)
    temp = np.maximum(288.0 * (pres / pres[:, -1:]) ** 0.22,
                      210.0).astype(np.float32)
    k = int(np.argmin(abs(pres[0] - p_cld)))
    shape = (npoints, ncol, nlev)
    ql = np.zeros(shape, np.float32)
    qi = np.zeros(shape, np.float32)
    cols = slice(None) if cldcols is None else slice(0, cldcols)
    ql[:, cols, k] = q_liq
    qi[:, cols, k] = q_ice
    rad = np.full((npoints, nlev), 10.0e-6, np.float32)
    radi = np.full((npoints, nlev), 30.0e-6, np.float32)
    z = np.zeros(shape, np.float32)
    return [t(x) for x in (pres, presf, temp, ql, qi, z, z, rad, radi, rad,
                           radi)], k


def _lidar_clear_sky_signal_equals_molecular():
    args, _ = _atmos()
    out = tl.lidar_simulator(*args)
    pnorm, pmol = out["pnorm"].numpy(), out["pmol"].numpy()
    np.testing.assert_allclose(
        pnorm, np.broadcast_to(pmol[:, None, :], pnorm.shape), rtol=1e-5)


def _lidar_cloud_enhances_backscatter_and_attenuates_below():
    args, k = _atmos(q_liq=5e-4)
    out = tl.lidar_simulator(*args)
    sr = out["pnorm"].numpy() / out["pmol"].numpy()[:, None, :]
    assert (sr[:, :, k] > tl.S_CLD).all()
    assert (sr[:, :, k + 2:] < 1.0).all()
    np.testing.assert_allclose(sr[:, :, :k], 1.0, rtol=1e-5)


def _lidar_molecular_profile_decreases_with_height():
    args, _ = _atmos()
    pmol = tl.lidar_simulator(*args)["pmol"].numpy()
    assert (np.diff(pmol[:, :15], axis=1) > 0).all()


def _parasol_tables_reproduced_at_nodes():
    cos = np.cos(np.deg2rad([0., 20., 40., 60., 80.]))
    for j, tau in enumerate(tl._PARASOL_TAU):
        r = tl.parasol(torch.tensor([tau], dtype=torch.float32),
                       torch.tensor([0.0])).numpy()
        np.testing.assert_allclose(r[0], tl._RLUMA[:, j] / cos, rtol=1e-5)
    r = tl.parasol(torch.tensor([0.0]), torch.tensor([10.0])).numpy()
    np.testing.assert_allclose(r[0], tl._RLUMB[:, 3] / cos, rtol=1e-5)


def _lidar_stats_cloud_fractions():
    args, k = _atmos(npoints=4, ncol=16, q_liq=5e-4, p_cld=80000.0,
                     cldcols=8)
    out = tl.lidar_simulator(*args)
    st = tl.lidar_stats(out["pnorm"], out["pmol"], out["refl"],
                        torch.zeros(4), args[0])
    cld = st["cldlayer"].numpy()
    np.testing.assert_allclose(cld[:, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(cld[:, 3], 0.5, atol=1e-6)
    np.testing.assert_allclose(cld[:, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(cld[:, 2], 0.0, atol=1e-6)
    np.testing.assert_allclose(st["lidarcld"].numpy()[:, k], 0.5, atol=1e-6)


def _lidar_stats_cfad_normalized():
    args, _ = _atmos(q_liq=2e-4)
    out = tl.lidar_simulator(*args)
    st = tl.lidar_stats(out["pnorm"], out["pmol"], out["refl"],
                        torch.zeros(4), args[0])
    np.testing.assert_allclose(st["cfad_sr"].numpy().sum(1), 1.0, atol=1e-5)


def _lidar_stats_parasol_land_masked():
    args, _ = _atmos(npoints=2)
    out = tl.lidar_simulator(*args)
    st = tl.lidar_stats(out["pnorm"], out["pmol"], out["refl"],
                        torch.tensor([0.0, 1.0]), args[0])
    pr = st["parasolrefl"].numpy()
    assert (pr[0] > 0).all()
    assert (pr[1] == tl.UNDEF).all()


def _mie_small_particle_rayleigh_limit():
    m = qb.m_wat(94.0, 10.0)
    x = np.array([1e-3, 3e-3, 1e-2])
    qe, qs = qb.mie_qext_qbsca(m, x)
    K = (m ** 2 - 1.0) / (m ** 2 + 2.0)
    np.testing.assert_allclose(qs, 4.0 * x ** 4 * abs(K) ** 2, rtol=1e-2)
    np.testing.assert_allclose(qe, 4.0 * x * K.imag, rtol=1e-2)


def _mie_large_sphere_extinction_paradox():
    qe, _ = qb.mie_qext_qbsca(qb.m_wat(94.0, 10.0), np.array([80.0, 120.0]))
    np.testing.assert_allclose(qe, 2.0, atol=0.25)


def _refractive_indices_94ghz():
    m = qb.m_wat(94.0, 10.0)
    assert 2.5 < m.real < 3.7 and 1.2 < abs(m.imag) < 2.2
    K2 = abs((m ** 2 - 1) / (m ** 2 + 2)) ** 2
    assert 0.65 < K2 < 0.85
    m = qb.m_ice(94.0, -20.0)
    assert 1.7 < m.real < 1.82 and 0.0 < m.imag < 0.01


def _radar_scene(npoints=2, ncol=4, nlev=20, cls_idx=2, q_gkg=0.5,
                 re_um=500.0, k_cld=None):
    z = np.linspace(16.0, 0.3, nlev)
    hgt = np.tile(z, (npoints, 1)).astype(np.float32)
    p = (1000.0 * np.exp(-z / 7.5))[None, :].repeat(npoints, 0)
    tc = (15.0 - 6.5 * z)[None, :].repeat(npoints, 0)
    rh = np.full_like(p, 50.0)
    hm = np.zeros((9, npoints, ncol, nlev), np.float32)
    re = np.zeros_like(hm)
    k = nlev - 3 if k_cld is None else k_cld
    hm[cls_idx, :, :, k] = q_gkg
    re[cls_idx, :, :, k] = re_um
    return [t(np.asarray(x, np.float32)) for x in (hgt, p, tc, rh, hm, re)], k


def _rain_reflectivity_realistic():
    args, k = _radar_scene(q_gkg=0.5, re_um=500.0)
    ze = qb.quickbeam_simulator(*args)["ze_non"].numpy()[:, :, k]
    assert ((ze > 5.0) & (ze < 45.0)).all(), ze


def _ice_cloud_weaker_than_rain():
    args, _ = _radar_scene(cls_idx=1, q_gkg=0.1, re_um=60.0, k_cld=5)
    ze_ice = qb.quickbeam_simulator(*args)["ze_non"].numpy()[:, :, 5]
    args, k = _radar_scene(cls_idx=2, q_gkg=0.5, re_um=500.0)
    ze_rain = qb.quickbeam_simulator(*args)["ze_non"].numpy()[:, :, k]
    assert (ze_ice < ze_rain.min()).all()
    assert (ze_ice > -35.0).all()


def _empty_volume_missing():
    args, k = _radar_scene()
    dbze = qb.quickbeam_simulator(*args)["dbze"].numpy()
    assert (dbze[:, :, :k] == qb.MISSING_DBZ).all()


def _attenuation_monotone_and_reduces_dbze():
    args, k = _radar_scene(q_gkg=1.0, re_um=400.0)
    out = {key: v.numpy() for key, v in
           qb.quickbeam_simulator(*args).items()}
    g = out["g_atten"]
    assert (np.diff(g, axis=-1) >= 0).all()
    assert g[..., -1].min() > 0.5
    h = out["h_atten"]
    assert (h[..., -1] > h[..., k - 1]).all()
    assert (out["dbze"][:, :, k] < out["ze_non"][:, :, k]).all()


def _cfad_normalization_and_binning():
    args, k = _radar_scene(q_gkg=0.5, re_um=500.0)
    cfad = qb.radar_cfad(qb.quickbeam_simulator(*args)["dbze"]).numpy()
    assert cfad.shape == (2, 15, 20)
    np.testing.assert_allclose(cfad[:, :, k].sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(cfad[:, :, 0].sum(1), 0.0, atol=1e-6)


def _lidar_only_freq_cloud():
    sr = np.ones((2, 4, 10), np.float32)
    dbze = np.full((2, 4, 10), qb.MISSING_DBZ, np.float32)
    sr[:, :, 4] = 30.0
    freq, tcc = qb.lidar_only_freq_cloud(t(sr), t(dbze))
    np.testing.assert_allclose(freq.numpy()[:, 4], 1.0)
    np.testing.assert_allclose(tcc.numpy(), 1.0)
    dbze[:, :, 4] = 0.0
    freq, tcc = qb.lidar_only_freq_cloud(t(sr), t(dbze))
    np.testing.assert_allclose(freq.numpy()[:, 4], 0.0)
    np.testing.assert_allclose(tcc.numpy(), 1.0)


PHYSICS = {f.__name__[1:]: f for f in (
    _lidar_clear_sky_signal_equals_molecular,
    _lidar_cloud_enhances_backscatter_and_attenuates_below,
    _lidar_molecular_profile_decreases_with_height,
    _parasol_tables_reproduced_at_nodes, _lidar_stats_cloud_fractions,
    _lidar_stats_cfad_normalized, _lidar_stats_parasol_land_masked,
    _mie_small_particle_rayleigh_limit, _mie_large_sphere_extinction_paradox,
    _refractive_indices_94ghz, _rain_reflectivity_realistic,
    _ice_cloud_weaker_than_rain, _empty_volume_missing,
    _attenuation_monotone_and_reduces_dbze, _cfad_normalization_and_binning,
    _lidar_only_freq_cloud)}


@pytest.mark.parametrize("case", sorted(PHYSICS))
def test_reference_physics_on_the_port(case):
    PHYSICS[case]()
