"""The port of the TPU kernels' zcw polynomial fit (ops/zcw_fit.py)
against the JAX package's own (ops/mcica_pallas.py:_class_columns,
_zcw_fit, _zcw_eval), on the CPU.

The fit constants are equal; zcw_eval agrees with _zcw_eval to 1e-5 abs
on cdf values drawn across [0, 1) with the head and tail bins forced in
(both evaluate the same float32 Horner chains eagerly; 7.2e-7 measured,
an ulp of the Horner sums); the fit stays within 5e-3 of the exact class
table, the reference's stated 4.7e-3 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.ops import mcica_pallas as mp
from geosradiation_gridcomp_tpu_torch.ops import mcica as tm
from geosradiation_gridcomp_tpu_torch.ops import zcw_fit as zf

torch.set_num_threads(1)


@pytest.mark.parametrize("inhm", [1, 2])
def test_fit_constants_equal_reference(inhm):
    np.testing.assert_array_equal(zf.class_columns(inhm),
                                  mp._class_columns(inhm))
    want, got = mp._zcw_fit(inhm), zf.zcw_fit(inhm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _cdf_and_classes():
    rng = np.random.default_rng(11)
    v = rng.random((6, 72, 140)).astype(np.float32)
    # the exact head (cdf < 1/999) and each tail bin
    v[0, 0, :8] = [0.0, 1e-4, 1.0e-3, 0.9955, 0.9965, 0.9975, 0.9985, 0.9999]
    cls = rng.integers(0, 3, (6, 72, 1))
    return v, cls


def test_eval_matches_reference():
    v, cls = _cdf_and_classes()
    want = np.asarray(mp._zcw_eval(
        jnp.asarray(v), (jnp.asarray(cls == 0), jnp.asarray(cls == 1)),
        mp._zcw_fit(1)))
    got = zf.zcw_eval(torch.as_tensor(v), (torch.as_tensor(cls == 0),
                                           torch.as_tensor(cls == 1)),
                      zf.zcw_fit(1))
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_fit_close_to_exact_table():
    v, cls = _cdf_and_classes()
    vt, ct = torch.as_tensor(v), torch.as_tensor(cls)
    fit = zf.zcw_eval(vt, (ct == 0, ct == 1), zf.zcw_fit(1))
    exact = tm.zcw_lookup_class(vt, ct.expand_as(vt),
                                torch.as_tensor(tm.zcw_class_columns(1)))
    assert float((fit - exact).abs().max()) <= 5e-3
