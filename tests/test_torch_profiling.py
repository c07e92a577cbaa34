"""The plain twins of the profiling kernels P1, P2 and P3 on the CPU.

P1 (ops/ffill_cuda.py): equal, bit for bit, to the JAX oracle's
_correlate on the transposed layout, and to the TPU kernel's own fill
(ops/mcica_pallas.py:_ffill) run in a pallas_call in interpret mode on
the [B, nlay, nsub] layout it documents. P2 (ops/gather_cuda.py): equal
to numpy's take (gather_rows' twin clamps its indices to the table). P3
(models/rrtmg/taumol_lw.py with parts): with every
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
    ROWS_CASES, gather_lanes, gather_lanes_plain, gather_rows,
    gather_rows_plain)
from geosradiation_gridcomp_tpu_torch.tools.profiling import (
    fused_mcica_check, gather_micro, kernel_ab, kernel_resources,
    taumol_lw_bisect as bisect_tool)

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


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_p2_rows_twin_equals_numpy_take_of_clipped(name):
    """gather_rows' twin in each case of the kernel's contract: numpy's
    take at the indices clipped to the table."""
    n, rows, ng, lo, hi, off = ROWS_CASES[name]
    rng = np.random.default_rng(4)
    tab = rng.standard_normal(rows * ng + off).astype(np.float32)[off:] \
        .reshape(rows, ng)
    idx = rng.integers(lo, hi, n).astype(np.int32)
    got = gather_rows(torch.as_tensor(idx), torch.as_tensor(tab))
    np.testing.assert_array_equal(
        got.numpy(), np.take(tab, np.clip(idx, 0, rows - 1), axis=0))


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


SASS = """
\t\tFunction : _Z6kernelPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;                /* 0x00000a0000017a02 */
        /*0010*/                   MUFU.EX2 R2, R3 ;                     /* 0x0000000300027308 */
        /*0020*/                   FADD R4, R2, R2 ;                     /* 0x0000000202047221 */
        /*0030*/                   MUFU.RCP R5, R4 ;                     /* 0x0000000400057308 */
        /*0040*/               @P0 BRA 0x20 ;                            /* 0xfffffffc00000947 */
        /*0050*/              @!P1 BRA 0x70 ;                            /* 0x0000000000109947 */
        /*0060*/                   BRA 0x10 ;                            /* 0xfffffffc00007947 */
        /*0070*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_kernel_resources_counts_sass_loops():
    """Each kernel's instructions and MUFU, and each backward branch's
    body (a forward branch is no loop)."""
    funcs = kernel_resources.sass_functions(SASS)
    assert list(funcs) == ["_Z6kernelPf", "_Z5otherv"]
    s = kernel_resources.summary(funcs["_Z6kernelPf"])
    assert (s["insns"], s["mufu"]) == (8, 2)
    pipes = lambda **kw: {c: kw.get(c, 0)
                          for c in kernel_resources.PIPE_CLASSES}
    assert s["loops"] == [
        dict(start="0x10", end="0x60", insns=6, mufu=2,
             pipes=pipes(mufu=2, fp32=1, ctrl=3)),
        dict(start="0x20", end="0x40", insns=3, mufu=1,
             pipes=pipes(mufu=1, fp32=1, ctrl=1))]
    assert kernel_resources.summary(funcs["_Z5otherv"]) == dict(
        insns=1, mufu=0, loops=[])


@pytest.mark.parametrize("insn,cls", [
    ("IADD3 R4, R2, R5, RZ", "alu"), ("LOP3.LUT R2, R3, R4, R5, 0x96, !PT",
                                      "alu"),
    ("SHF.L.W.U32.HI R3, R3, 0xd, R3", "alu"), ("@P0 ISETP.GE.AND P1, PT, "
                                                 "R2, R3, PT", "alu"),
    ("IMAD.IADD R4, R2, 0x1, R5", "imad"), ("IMAD.MOV.U32 R1, RZ, RZ, R2",
                                            "imad"),
    ("FFMA R4, R2, R3, R5", "fp32"), ("FADD R2, R2, -1", "fp32"),
    ("MUFU.RCP R5, R4", "mufu"), ("LDG.E R2, desc[UR4][R2.64]", "mem"),
    ("STS [R3], R2", "mem"), ("@!P1 BRA 0x70", "ctrl"), ("EXIT", "ctrl"),
    ("UIADD3 UR4, UR4, 0x1, URZ", "uniform")], ids=lambda x: str(x)[:12])
def test_kernel_resources_pipe_class(insn, cls):
    assert kernel_resources.pipe_class(insn) == cls


def test_kernel_ab_tensors_flattens_outputs():
    a, b, c = torch.zeros(2), torch.ones(3), torch.arange(4)
    assert [t.numel() for t in kernel_ab.tensors(
        {"y": (b, c), "x": a, "n": None})] == [2, 3, 4]
    assert kernel_ab.tensors(a)[0] is a


def test_kernel_ab_recording_keeps_each_step_kernels_first_call():
    """recording() sees every step kernel of a CPU refresh with its
    arguments, the twins reproduce the recorded wrappers there, and the
    scheme modules get their wrappers back after the block."""
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver import step
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw, sw
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    inp = example_inputs(4, NLAY, seed=0, device="cpu")
    cfg = RadiationConfig()
    nlit, ncld = step.sw_partition_bounds(inp.lons, inp.lats, inp.fcld,
                                          172.0, 12.0, cfg, bucket=2)
    before = {(m, a): getattr(dict(lw=lw, sw=sw)[m], a)
              for m, a, *_ in kernel_ab.STEP_KERNELS.values()}
    with kernel_ab.recording() as calls:
        step.radiation_refresh(
            inp, 172.0, 12.0, config=cfg, ict=69, icb=71, sw_nlit=nlit,
            sw_ncld=ncld, sw=sw.RRTMGSW.from_reference_tables("cpu"),
            lw=lw.RRTMGLW.from_reference_tables("cpu"))
    assert set(calls) == set(kernel_ab.STEP_KERNELS)
    assert calls["spcvmc"][2].get("ncld") == ncld
    for name, (fn, args, kw) in calls.items():
        got = kernel_ab.tensors(fn(*args, **kw))
        want = kernel_ab.tensors(kernel_ab.plain_twin(name)(*args, **kw))
        assert len(got) == len(want) > 0, name
        for x, y in zip(got, want):
            assert torch.equal(x, y), name
    for (m, a), fn in before.items():
        assert getattr(dict(lw=lw, sw=sw)[m], a) is fn


def test_kernel_ab_mcica_stage_feeds_the_kernel_as_the_scheme_did():
    """A checkout whose K1/K2 take play runs the kernel alone; one whose
    kernels take subkeys and band planes derives them first with the
    recorded helpers and passes them where the scheme passed them."""
    seen = []

    def kernel(*a, **kw):
        seen.append((a, kw))
        return "out"
    calls = {"mcica_optics_sw": (kernel, ("play", 1, 2, 3, 4, 5, 6, "rei",
                                          "rel", "pack", "zcw"), {"x": 1}),
             "mcica_optics_lw": (kernel, ("play", 1, 2), {"y": 2})}
    for m, name in (("sw", "mcica_optics_sw"), ("lw", "mcica_optics_lw")):
        assert kernel_ab.mcica_stage(torch, calls, m)() == "out"
        assert seen[-1] == calls[name][1:]
    keys = lambda play, order: ("keys", play, order)
    planes = (torch.zeros(3), torch.ones(3))
    calls = {
        "mcica_optics_sw": (kernel, ("k", 1, 2, 3, 4, 5, 6, "planes", "zcw"),
                            {"x": 1}),
        "mcica_optics_lw": (kernel, ("k", 1, 2), {"y": 2}),
        "sw.subcolumn_keys": (keys, ("play", (3, 2, 1, 0)), {}),
        "lw.subcolumn_keys": (keys, ("play", (0, 1, 2, 3)), {}),
        "sw.band_optics_coeffs_sw": (lambda rei, rel, iceflag: planes,
                                     ("rei", "rel"), {"iceflag": 3})}
    kernel_ab.mcica_stage(torch, calls, "sw")()
    a, kw = seen[-1]
    assert a[0] == ("keys", "play", (3, 2, 1, 0)) and a[1:7] == (
        1, 2, 3, 4, 5, 6) and a[8:] == ("zcw",) and kw == {"x": 1}
    assert torch.equal(a[7], torch.stack(planes))
    kernel_ab.mcica_stage(torch, calls, "lw")()
    assert seen[-1] == ((("keys", "play", (0, 1, 2, 3)), 1, 2), {"y": 2})


def test_kernel_ab_rotating_keeps_the_last_outputs_alive():
    """A rotated call holds its last `live` outputs and no older one, so
    each call's output lands in a block the previous calls did not
    write."""
    import weakref
    refs = []

    def fn():
        t = torch.zeros(4)
        refs.append(weakref.ref(t))
        return t
    run = kernel_ab.rotating(fn, live=3)
    for _ in range(7):
        run()
    assert [r() is not None for r in refs] == [False] * 4 + [True] * 3


def test_kernel_ab_lw_cloud_gathers_are_the_refresh_rows(monkeypatch):
    """The recorded gathers are the rows index - 1 and index of absice3
    and absliq1 at the radii of scene.example_inputs, as
    band_abs_coeffs_lw forms them (cldprmc_lw.py), and interpolating them
    gives its coefficients; gather_rows of them equals tab[index]."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import cldprmc_lw
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    monkeypatch.setattr(kernel_ab, "NCOL", 6)
    got = kernel_ab.lw_cloud_gathers(torch, torch.device("cpu"))
    assert list(got) == ["absice3 index-1", "absice3 index",
                         "absliq1 index-1", "absliq1 index"]
    inp = example_inputs(6, NLAY, seed=kernel_ab.SEED, device="cpu")
    tables = cldprmc_lw.lw_cloud_tables("cpu")
    want = cldprmc_lw.band_abs_coeffs_lw(inp.ri, inp.rl, tables)
    for name, factor, coef in (
            ("absice3", (inp.ri - 2.0) / 3.0, want[0]),
            ("absliq1", inp.rl - 1.5, want[1])):
        tab, hi = got[f"{name} index"]
        _, lo = got[f"{name} index-1"]
        assert torch.equal(tab, tables[name]) and tab.shape[1] == 16
        index = torch.clamp(torch.floor(factor).long(), 1, tab.shape[0] - 1)
        assert torch.equal(hi, index) and torch.equal(lo, index - 1)
        fint = (factor - index.float())[..., None]
        assert torch.equal(tab[lo] + fint * (tab[hi] - tab[lo]), coef)
        for i in (lo, hi):
            assert torch.equal(gather_rows(i.reshape(-1).int(), tab),
                               tab[i.reshape(-1)])
