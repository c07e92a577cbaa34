"""The port's SCOPS subcolumn sampler, precipitation assignment and
stat-grid regridding against the JAX CPU oracle, and the oracle's own
physics tests of them run on the port.

Parity (same numpy inputs from a seed on both sides): scops' frac_out and
prec_scops' prec_frac exact, for each overlap (scops draws the oracle's
threefry stream bit for bit: uniform(key, (nlev, npoints, nsubcol)) with
threefry.key(s) = jax.random.PRNGKey(s)); change_vertical_grid within
5e-5 relmax (max|a-b| / max|b|, tools/verify_tpu.py:33-36) on the values
that are not R_UNDEF, and R_UNDEF in exactly the same places, in linear
and log units.

`compare` is the satsim tests' comparison of a port result with the
oracle's, shared by the other tests/test_torch_satsim_*.py files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.satsim import prec_scops as j_prec_scops
from geosradiation_gridcomp_tpu.satsim import scops as j_scops
from geosradiation_gridcomp_tpu.satsim.stats import \
    change_vertical_grid as j_regrid
from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.satsim import prec_scops, scops
from geosradiation_gridcomp_tpu_torch.satsim.stats import (
    R_UNDEF, change_vertical_grid, csat_vgrid_bounds)

torch.set_num_threads(1)

TOL = 5e-5
# the reference's fill values: R_UNDEF / MISSING / UNDEF (-1e30, and
# UNDEF - 1), MISSING_DBZ, MODIS RE_FILL in m, R_GROUND
SENTINELS = np.float32([-1.0e30, -999.0, -999.0e-6, -1.0e20])
# fields whose values are a count of subcolumns over ncol: compared as
# counts, exactly
COUNT_FIELDS = ("fq_isccp", "totalcldarea", "fq_misr", "cldarea",
                "tau_vs_ctp", "cf_total", "cf_water", "cf_ice", "cf_high",
                "cf_mid", "cf_low", "cfad_sr", "cfad_dbze",
                "lidar_only_freq_cloud", "radar_lidar_tcc")


def t(x):
    """A CPU tensor holding a copy of x."""
    return torch.from_numpy(np.array(x))


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def is_sentinel(x):
    x = np.asarray(x)
    return np.isin(x.astype(np.float32), SENTINELS) | (np.abs(x) >= 1e29)


def compare(port, ref, name="", ncol=None, tol=TOL):
    """A port result against the oracle's, recursing through dicts:
    integer and bool arrays exact; float arrays with the sentinels in the
    same places and the other values within tol relmax; COUNT_FIELDS
    (value = count / ncol) also as counts, exactly. Returns the largest
    relmax seen."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (name, set(port) ^ set(ref))
        return max([compare(port[k], ref[k], f"{name}/{k}", ncol, tol)
                    for k in ref] + [0.0])
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if b.dtype.kind in "iub":
        mism = int((a != b).sum())
        assert mism == 0, f"{name}: {mism} of {b.size} differ"
        return 0.0
    sa, sb = is_sentinel(a), is_sentinel(b)
    assert (sa == sb).all(), f"{name}: fill values in other places " \
        f"({int((sa != sb).sum())} of {b.size})"
    err = relmax(a[~sb], b[~sb])
    assert err <= tol, f"{name}: relmax {err:.3e} > {tol:.0e}"
    leaf = name.rsplit("/", 1)[-1]
    if ncol is not None and leaf in COUNT_FIELDS:
        ca, cb = np.rint(a[~sb] * ncol), np.rint(b[~sb] * ncol)
        assert (ca == cb).all(), f"{name}: {int((ca != cb).sum())} counts " \
            "differ"
    return err


# ---------------------------------------------------------------------------
# scops / prec_scops
# ---------------------------------------------------------------------------

def _cc_profile(npoints=64, nlev=20):
    cc = np.zeros((npoints, nlev), np.float32)
    cc[:, 5] = 0.4
    cc[:, 6] = 0.4
    cc[:, 12] = 0.7
    conv = np.zeros_like(cc)
    conv[:, 12] = 0.2
    return cc, conv


def _random_cc(npoints=8, nlev=40, seed=0):
    rng = np.random.default_rng(seed)
    cc = np.where(rng.random((npoints, nlev)) < 0.4,
                  rng.random((npoints, nlev)), 0.0).astype(np.float32)
    conv = (cc * rng.uniform(0.0, 0.5, (npoints, nlev))).astype(np.float32)
    return cc, conv


@pytest.mark.parametrize("overlap", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 11])
def test_scops_matches_oracle(overlap, seed):
    cc, conv = _random_cc(seed=seed)
    want = np.asarray(j_scops(jax.random.PRNGKey(seed), jnp.asarray(cc),
                              jnp.asarray(conv), 50, overlap=overlap))
    got = scops(threefry.key(seed, device="cpu"), t(cc), t(conv), 50,
                overlap=overlap)
    assert got.dtype == torch.int8
    compare(got, want, "frac_out")


def test_scops_typed_key_and_raw_key_agree():
    """jax.random.key(s) (the stats test's key) and PRNGKey(s) (the cosp
    tests') draw the same bits, both threefry.key(s) here."""
    cc, conv = _cc_profile(npoints=8)
    a = j_scops(jax.random.key(0), jnp.asarray(cc), jnp.asarray(conv), 8)
    b = scops(threefry.key(0, device="cpu"), t(cc), t(conv), 8)
    compare(b, np.asarray(a), "frac_out")


def _prec_inputs(seed=0, npoints=8, nsub=50, nlev=40):
    rng = np.random.default_rng(seed)
    cc, conv = _random_cc(npoints, nlev, seed)
    frac = np.asarray(j_scops(jax.random.PRNGKey(seed), jnp.asarray(cc),
                              jnp.asarray(conv), nsub))
    ls = np.where(rng.random((npoints, nlev)) < 0.5, 1e-4, 0.0)
    cv = np.where(rng.random((npoints, nlev)) < 0.3, 1e-4, 0.0)
    return ls.astype(np.float32), cv.astype(np.float32), frac


@pytest.mark.parametrize("seed", [0, 1])
def test_prec_scops_matches_oracle(seed):
    ls, cv, frac = _prec_inputs(seed)
    want = np.asarray(j_prec_scops(jnp.asarray(ls), jnp.asarray(cv),
                                   jnp.asarray(frac)))
    got = prec_scops(t(ls), t(cv), t(frac))
    assert got.dtype == torch.int8
    compare(got, want, "prec_frac")
    assert set(np.unique(want)) >= {0, 1, 2, 3}


# the oracle's physics tests (tests/test_satsim_scops_isccp.py), on the
# port
def _scops_population_cloud_cover():
    cc, conv = _cc_profile(npoints=256)
    for overlap in (1, 2, 3):
        out = scops(threefry.key(0, device="cpu"), t(cc), t(conv), 128,
                    overlap=overlap)
        cover = (out != 0).double().mean(dim=(0, 1)).numpy()
        np.testing.assert_allclose(cover, cc[0], atol=0.01,
                                   err_msg=f"overlap={overlap}")


def _scops_convective_partition():
    cc, conv = _cc_profile(npoints=256)
    out = scops(threefry.key(1, device="cpu"), t(cc), t(conv), 128, 3)
    cv_cover = (out == 2).double().mean(dim=(0, 1)).numpy()
    np.testing.assert_allclose(cv_cover, conv[0], atol=0.01)


def _scops_max_overlap_aligns_adjacent_layers():
    cc, conv = _cc_profile()
    out = scops(threefry.key(2, device="cpu"), t(cc), t(conv), 64, 1)
    assert (out[:, :, 5] == out[:, :, 6]).all()


def _scops_maxran_correlation():
    cc, conv = _cc_profile(npoints=512)
    out = scops(threefry.key(3, device="cpu"), t(cc),
                torch.zeros(cc.shape), 64, 3).numpy()
    both_adj = ((out[:, :, 5] == 1) & (out[:, :, 6] == 1)).mean()
    assert both_adj > 0.35
    both_sep = ((out[:, :, 5] == 1) & (out[:, :, 12] == 1)).mean()
    assert abs(both_sep - 0.28) < 0.05


def _prec_scops_precip_where_cloud_and_below():
    npoints, nsub, nlev = 8, 32, 10
    frac = np.zeros((npoints, nsub, nlev), np.int8)
    frac[:, :16, 4] = 1
    ls = np.zeros((npoints, nlev), np.float32)
    ls[:, 4:] = 1e-4
    pf = prec_scops(t(ls), t(np.zeros_like(ls)), t(frac)).numpy()
    assert (pf[:, :16, 4] == 1).all() and (pf[:, 16:, 4] == 0).all()
    assert (pf[:, :16, 7] == 1).all() and (pf[:, 16:, 7] == 0).all()
    assert (pf[:, :, :4] == 0).all()


def _prec_scops_convective_fallback_five_percent():
    npoints, nsub, nlev = 4, 40, 6
    frac = np.zeros((npoints, nsub, nlev), np.int8)
    cv = np.full((npoints, nlev), 1e-4, np.float32)
    pf = prec_scops(t(np.zeros_like(cv)), t(cv), t(frac)).numpy()
    ncv = max(int(0.05 * nsub), 1)
    assert (pf[:, :ncv, :] == 2).all()
    assert (pf[:, ncv:, :] == 0).all()


# ---------------------------------------------------------------------------
# stat-grid regridding
# ---------------------------------------------------------------------------

def _ref_regrid(y, zle, zl, zu, log_units=False):
    """The oracle test's scalar loop evaluation of the overlap-weighted
    mean (tests/test_satsim_stats.py)."""
    npnt, ncol, nlev = y.shape
    r = np.full((npnt, ncol, len(zl)), R_UNDEF)
    for i in range(npnt):
        xu, xl = zle[i, :-1], zle[i, 1:]
        for k in range(len(zl)):
            if zu[k] <= zle[i, -1]:
                continue
            w = np.maximum(np.minimum(xu, zu[k]) - np.maximum(xl, zl[k]),
                           0.0)
            ws = w.sum()
            for j in range(ncol):
                yp = y[i, j]
                if log_units:
                    yp = np.where(yp != R_UNDEF, 10.0 ** (yp / 10.0), 0.0)
                if ws > 0:
                    v = (w * yp).sum() / ws
                    if log_units:
                        r[i, j, k] = 10 * np.log10(v) if v > 0 else R_UNDEF
                    else:
                        r[i, j, k] = v
    return r


def _grid(npnt=3, nlev=25):
    rng = np.random.default_rng(0)
    edges = np.sort(rng.uniform(0.0, 18000.0, (npnt, nlev - 1)), axis=1)
    return np.concatenate([np.full((npnt, 1), 19000.0), edges[:, ::-1],
                           np.zeros((npnt, 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("log_units", [False, True])
def test_regrid_matches_oracle(log_units):
    rng = np.random.default_rng(1)
    zle = _grid()
    if log_units:
        y = rng.uniform(-40.0, 20.0, (3, 4, 25)).astype(np.float32)
        y[:, :, ::5] = R_UNDEF
    else:
        y = rng.uniform(0.0, 5.0, (3, 4, 25)).astype(np.float32)
    zl, zu = csat_vgrid_bounds(40)
    want = np.asarray(j_regrid(jnp.asarray(y), jnp.asarray(zle), zl, zu,
                               log_units=log_units))
    got = change_vertical_grid(t(y), t(zle), zl, zu, log_units=log_units)
    compare(got, want, "regrid")


def _regrid_matches_scalar_reference():
    rng = np.random.default_rng(1)
    zle = _grid()
    y = rng.uniform(0.0, 5.0, (3, 4, 25)).astype(np.float32)
    zl, zu = csat_vgrid_bounds(40)
    got = change_vertical_grid(t(y), t(zle), zl, zu).numpy()
    np.testing.assert_allclose(got, _ref_regrid(y, zle, zl, zu), rtol=2e-5,
                               atol=1e-4)


def _regrid_log_units_scalar_reference():
    rng = np.random.default_rng(2)
    zle = _grid()
    y = rng.uniform(-40.0, 20.0, (3, 4, 25)).astype(np.float32)
    y[:, :, ::5] = R_UNDEF
    zl, zu = csat_vgrid_bounds(40)
    got = change_vertical_grid(t(y), t(zle), zl, zu, log_units=True).numpy()
    np.testing.assert_allclose(got, _ref_regrid(y, zle, zl, zu, True),
                               rtol=2e-4, atol=1e-3)


def _regrid_conserves_uniform_field():
    zle = _grid()
    y = np.full((3, 2, 25), 3.25, np.float32)
    zl, zu = csat_vgrid_bounds(40)
    got = change_vertical_grid(t(y), t(zle), zl, zu).numpy()
    valid = got != R_UNDEF
    assert valid.any()
    np.testing.assert_allclose(got[valid], 3.25, rtol=1e-6)


def test_vgrid_bounds_equal_the_oracle():
    from geosradiation_gridcomp_tpu.satsim.stats import \
        csat_vgrid_bounds as j_bounds
    for nlr, cs in ((40, True), (40, False), (60, False)):
        for a, b in zip(csat_vgrid_bounds(nlr, cs), j_bounds(nlr, cs)):
            np.testing.assert_array_equal(a, b)


PHYSICS = {f.__name__[1:]: f for f in (
    _scops_population_cloud_cover, _scops_convective_partition,
    _scops_max_overlap_aligns_adjacent_layers, _scops_maxran_correlation,
    _prec_scops_precip_where_cloud_and_below,
    _prec_scops_convective_fallback_five_percent,
    _regrid_matches_scalar_reference, _regrid_log_units_scalar_reference,
    _regrid_conserves_uniform_field)}


@pytest.mark.parametrize("case", sorted(PHYSICS))
def test_reference_physics_on_the_port(case):
    PHYSICS[case]()
