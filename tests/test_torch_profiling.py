"""The plain twins of the profiling kernels P1, P2 and P3 on the CPU.

P1 (ops/ffill_cuda.py): equal, bit for bit, to the JAX oracle's
_correlate on the transposed layout, and to the TPU kernel's own fill
(ops/mcica_pallas.py:_ffill) run in a pallas_call in interpret mode on
the [B, nlay, nsub] layout it documents. P2 (ops/gather_cuda.py): equal
to numpy's take. P3 (models/rrtmg/taumol_lw.py with parts): with every
part it is taumol_lw bit for bit; each variant zeroes exactly its terms
(no Planck fractions without "planck", taug untouched by "planck", and
taug elementwise at most the full value, since every dropped term is
non-negative). The profiling entry points refuse to run without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu.ops import mcica_pallas as mp
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
    PARTS, VARIANTS, taumol_lw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import \
    taumol_lw_bisect
from geosradiation_gridcomp_tpu_torch.ops.ffill_cuda import ffill, ffill_plain
from geosradiation_gridcomp_tpu_torch.ops.gather_cuda import (
    gather_lanes, gather_lanes_plain, gather_rows, gather_rows_plain)
from geosradiation_gridcomp_tpu_torch.tools.profiling import (
    fused_mcica_check, gather_micro, taumol_lw_bisect as bisect_tool)

torch.set_num_threads(1)

B, NLAY, NSUB = 4, 72, 140


def _fill_inputs():
    rng = np.random.default_rng(2)
    v = rng.random((B, NLAY, NSUB)).astype(np.float32)
    keep = (rng.random((B, NLAY, NSUB)) > 0.6).astype(np.float32)
    return v, keep


def test_p1_twin_equals_oracle_correlate():
    v, keep = _fill_inputs()
    want = np.asarray(jm._correlate(jnp.asarray(v).swapaxes(1, 2),
                                    jnp.asarray(keep > 0).swapaxes(1, 2)))
    got = ffill(torch.as_tensor(v), torch.as_tensor(keep))
    np.testing.assert_array_equal(got.numpy(), want.swapaxes(1, 2))


def test_p1_twin_equals_tpu_fill_in_interpret_mode():
    v, keep = _fill_inputs()

    def kern(v_ref, k_ref, o_ref):
        o_ref[...] = mp._ffill(v_ref[...], k_ref[...], NLAY)

    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(v.shape, jnp.float32),
        interpret=True)(jnp.asarray(v), jnp.asarray(keep))
    got = ffill_plain(torch.as_tensor(v), torch.as_tensor(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_p2_twins_equal_numpy_take():
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((585, 16)).astype(np.float32)
    idx = rng.integers(0, 585, 2 * 64 * 128).astype(np.int32)
    got = gather_rows(torch.as_tensor(idx), torch.as_tensor(tab))
    np.testing.assert_array_equal(got.numpy(), np.take(tab, idx, axis=0))
    tabt = np.pad(tab.T, ((0, 0), (0, 640 - 585)))
    idx2d = idx.reshape(-1, 128)
    got = gather_lanes(torch.as_tensor(idx2d), torch.as_tensor(tabt))
    want = np.take(tabt, idx2d.reshape(2, 64, 128), axis=1)  # [16, 2, 64, 128]
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 0, 2, 3)
                                  .reshape(2 * 16 * 64, 128))
    np.testing.assert_array_equal(
        gather_lanes_plain(torch.as_tensor(idx2d), torch.as_tensor(tabt))
        .numpy(), got.numpy())
    np.testing.assert_array_equal(
        gather_rows_plain(torch.as_tensor(idx), torch.as_tensor(tab))
        .numpy(), np.take(tab, idx, axis=0))


@pytest.fixture(scope="module")
def lw():
    coefs, tabs = bisect_tool.lw_coefs(torch.device("cpu"), 4)
    assert bool(coefs.lower.any()) and not bool(coefs.lower.all())
    return coefs, tabs, taumol_lw(coefs, tabs)


def test_p3_twin_with_every_part_is_taumol(lw):
    coefs, tabs, full = lw
    for x, y in zip(taumol_lw_bisect(coefs, tabs, PARTS), full):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_p3_variant_zeroes_exactly_its_terms(lw, variant):
    coefs, tabs, (tg_full, pf_full) = lw
    parts = VARIANTS[variant]
    tg, pf = taumol_lw_bisect(coefs, tabs, parts)
    if "planck" in parts:
        assert torch.equal(pf, pf_full)
    else:
        assert not bool(pf.any())
    if parts - {"planck"} == PARTS - {"planck"}:
        assert torch.equal(tg, tg_full)
    else:
        assert bool((tg <= tg_full).all()) and not torch.equal(tg, tg_full)
    if not parts - {"planck"}:
        assert not bool(tg.any())


def test_p3_rejects_unknown_parts(lw):
    with pytest.raises(ValueError):
        taumol_lw_bisect(lw[0], lw[1], {"major", "scat"})


@pytest.mark.parametrize("tool", [fused_mcica_check, gather_micro,
                                  bisect_tool])
def test_profiling_entry_points_need_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tool.main([])
