"""The port's captured step entries (driver/compiled.py, driver/step.py) on
the CPU, at 8 columns x 72 levels on the realistic scene, doy 172, 12 UTC.

On the CPU the entries run their eager bodies (the caller asked for the
CPU); what is held here is what the capture relies on:
- doy and utc_hours given as 0-d float32 tensors give results bitwise
  equal to Python floats, and both within 5e-5 relmax of the JAX oracle
  (the gate of tests/test_torch_solar.py);
- StaticIO, the copy-in / clone-out around a replay, with the body called
  in place of replay(): two calls with other inputs and another doy each
  give the eager body's results bitwise, and what it returns aliases
  neither itself nor the static buffers;
- the cache key changes with config, ict / icb, sw_nlit / sw_ncld, the
  shapes and the aerosol structure, and with nothing else;
- the refresh's route is a static test (a card, not plain, under every
  scheme pair); Captured's bookkeeping with torch.cuda's graph API stood
  in for;
- a second refresh + update makes no torch.as_tensor / torch.tensor call
  on host data and reads no tensor back to the host (Tensor.item,
  tolist, numpy, cpu, __bool__, __int__, __float__), outside the kernel
  wrappers, which on the CPU run their plain twins: on a card each of
  those would synchronise the stream, and none can be captured;
- the switch between a kernel and its twin (kernels/twins.py): use_kernel
  on a card outside twins() only, twins(False) a no-op even when nested,
  and a captured entry inside twins() running its body unrouted.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver.compiled import (StaticIO,
                                                              clone_tree)
from geosradiation_gridcomp_tpu_torch.kernels.twins import (twins,
                                                           use_kernel)
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.parallel.sharding import tree_leaves
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
CFG = RadiationConfig()
T_CFG = TConfig()
# the kernel wrappers as the scheme modules call them
WRAPPERS = {lwm: ("mcica_optics_lw", "taumol_lw_fast", "rtrnmc_fast"),
            swm: ("mcica_optics_sw", "taumol_sw_fast", "spcvmc_fast")}


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


@pytest.fixture(scope="module")
def scene():
    inp = example_inputs(NCOL, NLEV, device="cpu")
    ple0 = inp.ple[0].numpy()
    ict, icb = CFG.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    nlit, ncld = tstep.sw_partition_bounds(inp.lons, inp.lats, inp.fcld,
                                           DOY, UTC, T_CFG, bucket=1)
    mods = dict(sw=swm.RRTMGSW.from_reference_tables("cpu"),
                lw=lwm.RRTMGLW.from_reference_tables("cpu"))
    return dict(inp=inp, ict=ict, icb=icb, nlit=nlit, ncld=ncld, mods=mods)


def _static(scene):
    return dict(config=T_CFG, ict=scene["ict"], icb=scene["icb"],
                sw_nlit=scene["nlit"], sw_ncld=scene["ncld"],
                **scene["mods"])


def _step(scene, inp, scalar=float, doy=DOY, utc=UTC):
    """refresh + update through the entries, doy and utc_hours (and the
    update's doy + 0.01 and utc + 0.25) passed through scalar."""
    sol, irr = tstep.radiation_refresh(inp, scalar(doy), scalar(utc),
                                       **_static(scene))
    upd = tstep.radiation_update(sol, irr, inp.tsinst + 0.5, inp.lons,
                                 inp.lats, inp.ple, scalar(doy + 0.01),
                                 scalar(utc + 0.25), config=T_CFG)
    return sol, irr, upd


def test_tensor_scalars_bitwise_equal_floats_and_oracle(scene):
    a = _step(scene, scene["inp"])
    b = _step(scene, scene["inp"], lambda x: torch.tensor(x,
                                                        dtype=torch.float32))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    ji = _example_inputs(NCOL, NLEV)
    sol, irr = jstep.radiation_refresh(
        ji, DOY, UTC, config=CFG, ict=scene["ict"], icb=scene["icb"],
        sw_nlit=scene["nlit"], sw_ncld=scene["ncld"])
    upd = jstep.radiation_update(sol, irr, ji.tsinst + 0.5, ji.lons,
                                 ji.lats, ji.ple, jnp.float32(DOY + 0.01),
                                 UTC + 0.25, config=CFG)
    for x, y in ((b[0], sol), (b[1], irr)):
        for f in x._fields:
            assert relmax(getattr(x, f), getattr(y, f)) <= 5e-5, f
    for g in ("sw", "lw"):
        for k in upd[g]:
            assert relmax(b[2][g][k], upd[g][k]) <= 5e-5, (g, k)
    for k in ("alw", "blw"):
        assert relmax(b[2][k], upd[k]) <= 5e-5, k


def _storages(tree):
    return [t.untyped_storage().data_ptr() for t in tree_leaves(tree)]


def _replay(io, traced, replay):
    """What a captured entry does around its replay: copy traced in,
    replay, clone the outputs."""
    io.load(traced)
    return clone_tree(replay())


def test_static_io_copies_in_and_clones_out(scene):
    body, static = tstep.radiation_refresh_eager, _static(scene)
    calls = [dict(inp=scene["inp"], doy=DOY, utc_hours=UTC, sw_aero=None,
                  lw_aero=None),
             dict(inp=example_inputs(NCOL, NLEV, seed=1, device="cpu"),
                  doy=torch.tensor(200.25), utc_hours=3.5, sw_aero=None,
                  lw_aero=None)]
    io = StaticIO(calls[0], torch.device("cpu"))
    outs = [_replay(io, c, lambda: body(**io.arguments, **static))
            for c in calls]
    eager = [body(**c, **static) for c in calls]
    for got, want in zip(outs, eager):
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(x, y)
    # the first call's states survive the second call
    assert not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(outs[0]), tree_leaves(outs[1])))
    mine = [p for o in outs for p in _storages(o)]
    assert len(set(mine)) == len(mine)
    assert not set(mine) & {b.untyped_storage().data_ptr()
                            for b in io.buffers}
    # the update, whose states come in as NamedTuples of tensors
    upd = tstep.radiation_update_eager
    args = [dict(solar_state=o[0], irrad_state=o[1],
                 tsinst=c["inp"].tsinst + 0.5, lons=c["inp"].lons,
                 lats=c["inp"].lats, ple=c["inp"].ple, doy=d, utc_hours=u)
            for o, c, d, u in zip(outs, calls, (DOY, 201.0),
                                  (UTC, torch.tensor(4.0)))]
    io = StaticIO(args[0], torch.device("cpu"))
    for a in args:
        got = _replay(io, a, lambda: upd(**io.arguments, config=T_CFG))
        want = upd(**a, config=T_CFG)
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(x, y)
        assert not set(_storages(got)) & {
            b.untyped_storage().data_ptr() for b in io.buffers}


def _key(entry, *args, **kwargs):
    bound = entry.signature.bind(*args, **kwargs)
    bound.apply_defaults()
    return entry.key(bound.arguments)


def test_refresh_key(scene):
    inp, static = scene["inp"], _static(scene)
    entry = tstep.radiation_refresh
    base = _key(entry, inp, DOY, UTC, **static)
    other = example_inputs(NCOL, NLEV, seed=3, device="cpu")
    for same in (_key(entry, inp, 10.5, 0.25, **static),
                 _key(entry, inp, torch.tensor(10.5), torch.tensor(1.0),
                      **static),
                 _key(entry, other, DOY, UTC, **static)):
        assert same == base
    wide = example_inputs(NCOL + 8, NLEV, device="cpu")
    rng = np.random.default_rng(0)
    t = lambda nb: torch.as_tensor(rng.uniform(0.0, 0.1, (NCOL, NLEV, nb)),
                                   dtype=torch.float32)
    changes = [dict(config=TConfig(iceflag_sw=2)), dict(ict=static["ict"] + 1),
               dict(icb=static["icb"] - 1), dict(sw_nlit=None),
               dict(sw_ncld=None), dict(sw=swm.RRTMGSW.from_reference_tables(
                   "cpu")), dict(plain=True)]
    keys = [_key(entry, inp, DOY, UTC, **{**static, **c}) for c in changes]
    keys += [_key(entry, wide, DOY, UTC, **static),
             _key(entry, inp._replace(t=inp.t.double()), DOY, UTC,
                  **static),
             _key(entry, inp, DOY, UTC, sw_aero=(t(14), t(14), t(14)),
                  **static),
             _key(entry, inp, DOY, UTC, lw_aero=t(16), **static),
             _key(entry, inp, DOY, UTC, lw_aero=(t(16), t(16), t(16)),
                  **static)]
    assert base not in keys and len(set(keys)) == len(keys)


def test_update_key(scene):
    inp = scene["inp"]
    sol, irr = tstep.radiation_refresh_eager(inp, DOY, UTC, **_static(scene))
    entry = tstep.radiation_update

    def key(i, s, r, doy, cfg=T_CFG):
        return _key(entry, s, r, i.tsinst, i.lons, i.lats, i.ple, doy, UTC,
                    config=cfg)
    base = key(inp, sol, irr, DOY)
    assert key(inp, sol, irr, torch.tensor(3.0)) == base
    assert key(inp, sol._replace(flxn=sol.flxn + 1.0), irr, 9.0) == base
    assert key(inp, sol, irr, DOY, TConfig(outputs=frozenset())) != base
    cut = lambda x: type(x)(*(f[:4] for f in x))
    assert key(cut(inp), cut(sol), cut(irr), DOY) != base


def _counting(monkeypatch):
    """Count host-data tensor constructions and reads back to the host
    made outside the kernel wrappers; returns the list they land in."""
    found, inside = [], []
    for name in ("as_tensor", "tensor"):
        fn = getattr(torch, name)

        def counted(data, *args, _fn=fn, _name=name, **kwargs):
            if not inside and not isinstance(data, torch.Tensor):
                found.append(f"torch.{_name}({type(data).__name__})")
            return _fn(data, *args, **kwargs)
        monkeypatch.setattr(torch, name, counted)
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__"):
        fn = getattr(torch.Tensor, name)

        def read(self, *args, _fn=fn, _name=name, **kwargs):
            if not inside:
                found.append(f"Tensor.{_name}")
            return _fn(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, read)
    for mod, names in WRAPPERS.items():
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*args, _fn=fn, **kwargs):
                inside.append(1)
                try:
                    return _fn(*args, **kwargs)
                finally:
                    inside.pop()
            monkeypatch.setattr(mod, name, wrapper)
    return found


def test_second_step_copies_nothing_from_the_host(scene, monkeypatch):
    _step(scene, scene["inp"])
    found = _counting(monkeypatch)
    _step(scene, scene["inp"], doy=DOY + 0.5, utc=UTC + 1.0)
    assert found == []
    # the counters see what they are meant to see
    torch.as_tensor(np.zeros(2))
    float(scene["inp"].t[0, 0])
    assert found == ["torch.as_tensor(ndarray)", "Tensor.__float__"]


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay does nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch):
    """torch.cuda's stream and graph API as stand-ins that run on the
    CPU: the warm-up and the capture run the body as they would on a
    card, a replay runs nothing."""
    from contextlib import nullcontext

    from geosradiation_gridcomp_tpu_torch.driver import compiled

    for name, value in (
            ("current_stream", lambda device=None: _FakeStream()),
            ("Stream", lambda device=None: _FakeStream()),
            ("stream", lambda s: nullcontext()),
            ("device", lambda d: nullcontext()),
            ("CUDAGraph", _FakeGraph),
            ("graph", lambda g, pool=None, stream=None: nullcontext()),
            ("graph_pool_handle", lambda: (0, 1))):
        monkeypatch.setattr(torch.cuda, name, value)
    compiled.graph_pool.cache_clear()
    monkeypatch.setattr(compiled, "graph_pool",
                        functools.lru_cache(maxsize=None)(
                            compiled.graph_pool.__wrapped__))


def test_captured_bookkeeping(monkeypatch):
    """Captured with torch.cuda's graph API stood in for on the CPU: the
    first call with a key warms up and captures (the body runs twice)
    and replays; the wrapper calls of the warm-up and the capture are
    not counted, each replay counts what its capture recorded; a later
    call copies in and replays without running the body; a new static
    value captures anew; the eager route runs the body once; a capture
    that fails raises and counts nothing."""
    from geosradiation_gridcomp_tpu_torch.driver.compiled import Captured
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES

    _fake_cuda(monkeypatch)
    runs, fail = [], []

    def body(x, s, *, k):
        LAUNCHES["toy"] += 1
        runs.append(1)
        if fail and len(runs) == 2:
            raise RuntimeError("capture refused")
        return dict(y=x * s + k, x=x)

    cpu = lambda arguments, device: arguments \
        if arguments["k"] >= 0 else None
    entry = Captured(body, ("k",), route=cpu)
    x = torch.arange(6.0).reshape(2, 3)
    LAUNCHES.clear()
    out = entry(x, 2.0, k=1)
    assert len(runs) == 2 and dict(LAUNCHES) == {"toy": 1}
    assert torch.equal(out["y"], x * 2.0 + 1)
    graph = next(iter(entry.graphs.values()))
    assert graph.graph.replays == 1
    assert out["x"].data_ptr() not in {b.data_ptr() for b in graph.io.buffers}
    entry(x + 1.0, torch.tensor(3.0), k=1)
    assert len(runs) == 2 and dict(LAUNCHES) == {"toy": 2}
    assert graph.graph.replays == 2
    assert torch.equal(graph.io.buffers[0], x + 1.0)
    assert float(graph.io.buffers[1]) == 3.0
    entry(x, 2.0, k=2)
    assert len(runs) == 4 and len(entry.graphs) == 2
    assert dict(LAUNCHES) == {"toy": 3}
    assert torch.equal(entry(x, 2.0, k=-1)["y"], x * 2.0 - 1)
    assert len(runs) == 5 and dict(LAUNCHES) == {"toy": 4}
    runs.clear()
    fail.append(1)
    with pytest.raises(RuntimeError, match="capture refused"):
        entry(x, 2.0, k=5)
    assert len(entry.graphs) == 2 and dict(LAUNCHES) == {"toy": 4}


def test_refresh_route_is_a_static_test(scene, monkeypatch):
    """The refresh takes the graph on a card with the kernels (not plain)
    under every pair of SW and LW schemes (Chou-Suarez, RRTMG, RRTMGP,
    and RRTMGP's native engine), and then gets the per-device table
    modules where the caller gave none; CPU tensors and plain=True stay
    eager; the update takes it on a card."""
    from geosradiation_gridcomp_tpu_torch.config import Scheme
    from geosradiation_gridcomp_tpu_torch.driver.compiled import on_card

    built = []
    monkeypatch.setattr(tstep, "reference_modules",
                        lambda device: built.append(device) or ("S", "L"))
    card = torch.device("cuda", 0)
    base = dict(inp=scene["inp"], config=T_CFG, plain=False,
                **scene["mods"])
    route = tstep._refresh_route
    pairs = [TConfig(sw_scheme=s, lw_scheme=l) for s in Scheme
             for l in Scheme]
    pairs.append(TConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP,
                         rrtmgp_kdist_sw="sw.npz", rrtmgp_kdist_lw="lw.npz"))
    assert len(pairs) == 10
    for cfg in pairs:
        assert route({**base, "config": cfg}, torch.device("cpu")) is None
        assert route({**base, "config": cfg, "plain": True}, card) is None
        got = {**base, "config": cfg}
        assert route(got, card) == got
    assert route(base, card) == base and built == []
    got = route({**base, "sw": None}, card)
    assert (got["sw"], got["lw"]) == ("S", scene["mods"]["lw"])
    assert built == [card]
    assert on_card(base, card) is base
    assert on_card(base, torch.device("cpu")) is None
    assert on_card(base, None) is None


class _OnCard:
    """A stand-in for a CUDA tensor: use_kernel reads only its device."""
    device = torch.device("cuda", 0)


def test_use_kernel_only_on_a_card_outside_twins():
    """use_kernel is false for CPU tensors; for a CUDA tensor it is true
    outside twins() and false inside."""
    assert not use_kernel(torch.zeros(2))
    assert use_kernel(_OnCard())
    with twins():
        assert not use_kernel(_OnCard())
        assert not use_kernel(torch.zeros(2))
    assert use_kernel(_OnCard())


def test_twins_nest_and_an_inner_false_changes_nothing():
    """twins(False) is a no-op: alone it leaves the kernels on, inside
    twins() it cannot turn the twins off; the depth unwinds on an
    exception."""
    with twins(False):
        assert use_kernel(_OnCard())
    with twins():
        with twins(False):
            assert not use_kernel(_OnCard())
        with twins():
            assert not use_kernel(_OnCard())
        assert not use_kernel(_OnCard())
    with pytest.raises(RuntimeError):
        with twins():
            raise RuntimeError("body failed")
    assert use_kernel(_OnCard())


def test_captured_entry_inside_twins_runs_its_body(monkeypatch):
    """Inside twins() a captured entry whose route would capture runs its
    body once, eagerly, without consulting its route: a plain body never
    records a graph. Outside it, the same call captures."""
    from geosradiation_gridcomp_tpu_torch.driver.compiled import Captured

    _fake_cuda(monkeypatch)
    routed, runs = [], []

    def body(x):
        runs.append(use_kernel(_OnCard()))
        return x + 1.0

    def route(arguments, device):
        routed.append(device)
        return arguments
    entry = Captured(body, (), route=route)
    x = torch.arange(3.0)
    with twins():
        assert torch.equal(entry(x), x + 1.0)
    assert routed == [] and runs == [False] and entry.graphs == {}
    assert torch.equal(entry(x), x + 1.0)
    assert len(routed) == 1 and len(entry.graphs) == 1
    assert runs[1:] == [True, True]         # its warm-up and capture
