"""The port's captured COSP entry (satsim/cosp.py:cosp_simulator, the
reference's jitted cosp_simulator) and the radar's static class tuple, on
the CPU at 6 points x 16 subcolumns x 72 levels on chip_smoke's satsim
scene (the realistic scene, seed 0; graupel in the snow's levels).

On the CPU the entry runs its eager body (the caller asked for the CPU);
what is held here is what the capture on a card relies on:
- the key holds the config (None filled in as SatsimConfig()) and the
  traced tensors' shapes, and not the threefry key's or the inputs'
  values; CPU inputs run the body;
- with torch.cuda's stream and graph API stood in for
  (tests/test_torch_step_capture.py), the first call warms the body up
  and captures it, and a later call copies its key and inputs in and
  returns clones of the static outputs;
- a second cosp_simulator call makes no torch.as_tensor / torch.tensor /
  torch.from_numpy call on host data, indexes no tensor with a list, an
  array or a mask and reads no tensor back to the host
  (tests/test_torch_scheme_capture.py:_counting): on a card each would
  synchronise the stream, and none can be captured. Undoing any one of
  the satsim path's device caches (tables.on_device) or bringing back
  the radar's per-class presence read makes it fail. The table it
  returns (lidar srbval) is a copy, not the shared cache;
- quickbeam_simulator over a static tuple of classes: the five classes
  GEOS fills equal the nine-class call bit for bit where the convective
  planes are zero, and the four without graupel equal the five where
  graupel is zero (an absent class adds exact zeros).
"""

import os
import sys

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu_torch.driver import compiled
from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.parallel.sharding import tree_leaves
from geosradiation_gridcomp_tpu_torch.satsim import SatsimConfig, cosp
from geosradiation_gridcomp_tpu_torch.satsim import radar as qb
from geosradiation_gridcomp_tpu_torch.satsim.lidar import SRBVAL
from tests.test_torch_scheme_capture import _counting
from tests.test_torch_step_capture import _fake_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import satsim_inputs  # noqa: E402

torch.set_num_threads(1)

NPNT, NCOL, NLEV = 6, 16, 72
CFG = SatsimConfig(ncolumns=NCOL)
entry = cosp.cosp_simulator


def _inputs(npnt=NPNT, scale=1.0):
    inp = satsim_inputs(torch, npnt, "cpu")
    return inp._replace(qg=0.5 * inp.qs, qv=scale * inp.qv)


@pytest.fixture(scope="module")
def inp():
    return _inputs()


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _routed_key(key, inputs, config=None):
    bound = entry.signature.bind(key, inputs, config)
    bound.apply_defaults()
    return entry.key(entry.route(dict(bound.arguments), None))


# --------------------------------------------------------------------------
# the key and the route
# --------------------------------------------------------------------------

def test_key_holds_the_config_and_the_shapes(inp, monkeypatch):
    cpu_key = threefry.key(11, device="cpu")
    # CPU inputs take the eager body
    bound = entry.signature.bind(cpu_key, inp)
    bound.apply_defaults()
    assert entry.route(dict(bound.arguments), torch.device("cpu")) is None
    # the inputs' device decides, as on a card
    seen = []
    monkeypatch.setattr(cosp, "on_card",
                        lambda arguments, device: seen.append(device)
                        or arguments)
    base = _routed_key(cpu_key, inp)
    assert seen == [inp.t.device]
    static, traced = base
    assert static == (("config", SatsimConfig()),)
    assert _routed_key(cpu_key, inp, SatsimConfig()) == base
    assert _routed_key(threefry.key(12, device="cpu"), inp) == base
    assert _routed_key(cpu_key, _inputs(scale=0.5)) == base
    others = [_routed_key(cpu_key, inp, CFG),
              _routed_key(cpu_key, inp, SatsimConfig(use_vgrid=False)),
              _routed_key(cpu_key, _inputs(NPNT + 2))]
    assert base not in others and len(set(others)) == len(others)
    names = dict(traced)
    assert names["key"] == (compiled.TENSOR, (2,), torch.int64,
                            torch.device("cpu"))
    typ, fields = names["inp"]
    assert typ is cosp.SatsimInputs
    assert fields[inp._fields.index("t")][1] == (NPNT, NLEV)
    assert fields[inp._fields.index("ple")][1] == (NPNT, NLEV + 1)


def test_replays_copy_in_and_return_clones(inp, monkeypatch):
    """torch.cuda's graph API stood in for and CPU inputs routed to the
    graph: the first call runs the body twice (warm-up, capture) and
    returns the eager result; a later call with another key and inputs
    runs no body, copies them into the static buffers and returns clones
    of the static outputs; None and SatsimConfig() share the graph."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(cosp, "on_card", lambda arguments, device:
                        arguments)
    monkeypatch.setattr(entry, "graphs", {})
    runs = []

    def body(*args, **kwargs):
        runs.append(1)
        return cosp.cosp_simulator_eager(*args, **kwargs)
    monkeypatch.setattr(entry, "body", body)
    keys = [threefry.key(s, device="cpu") for s in (11, 12)]
    want = cosp.cosp_simulator_eager(keys[0], inp, CFG)
    LAUNCHES.clear()
    got = entry(keys[0], inp, CFG)
    assert len(runs) == 2 and len(entry.graphs) == 1 and not LAUNCHES
    assert _equal(got, want)
    graph = next(iter(entry.graphs.values()))
    static = {t.data_ptr() for t in tree_leaves(graph.out)}
    assert not static & {t.data_ptr() for t in tree_leaves(got)}
    other = _inputs(scale=0.5)
    again = entry(keys[1], other, CFG)
    assert len(runs) == 2 and graph.graph.replays == 2
    # the stand-in replay runs nothing: the clones hold the capture's
    # outputs, the buffers the new call's key and inputs
    assert _equal(again, want)
    assert not {t.data_ptr() for t in tree_leaves(again)} & static
    assert torch.equal(graph.io.buffers[0], keys[1])
    assert torch.equal(graph.io.buffers[1 + inp._fields.index("qv")],
                       other.qv)
    entry(keys[0], inp)
    assert len(runs) == 4 and len(entry.graphs) == 2
    entry(keys[0], inp, SatsimConfig())
    assert len(runs) == 4 and len(entry.graphs) == 2


# --------------------------------------------------------------------------
# host copies and read-backs on a second call
# --------------------------------------------------------------------------

def test_second_call_copies_nothing_from_the_host(inp, monkeypatch):
    keys = [threefry.key(s, device="cpu") for s in (11, 12)]
    entry(keys[0], inp, CFG)
    found = _counting(monkeypatch)
    out = entry(keys[1], inp, CFG)
    assert found == []
    assert torch.equal(out["lidar"]["srbval"],
                       torch.as_tensor(SRBVAL, dtype=torch.float32))
    # the counters see what they are meant to see
    found.clear()
    torch.as_tensor(np.zeros(2))
    bool((inp.qg > 0.0).any())
    assert found == ["torch.as_tensor(ndarray)", "Tensor.__bool__"]


def test_returned_table_is_a_copy(inp):
    """srbval is a table the lidar statistics put on the device once:
    what a call returns is a copy, which a caller may write into."""
    key = threefry.key(11, device="cpu")
    first = entry(key, inp, CFG)["lidar"]["srbval"]
    first.fill_(0.0)
    second = entry(key, inp, CFG)["lidar"]["srbval"]
    assert torch.equal(second, torch.as_tensor(SRBVAL, dtype=torch.float32))


# --------------------------------------------------------------------------
# the radar's static classes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def radar_args(inp):
    """quickbeam_simulator's arguments as cosp_simulator builds them
    (the five large-scale classes from the scene, graupel included),
    with the four convective planes as zeros: nine planes in the class
    table's order."""
    calls = []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return qb.quickbeam_simulator(*args, **kwargs)
    cosp.quickbeam_simulator, saved = recorded, cosp.quickbeam_simulator
    try:
        cosp.cosp_simulator_eager(threefry.key(11, device="cpu"), inp, CFG)
    finally:
        cosp.quickbeam_simulator = saved
    (args, kwargs), = calls
    assert kwargs == dict(classes=cosp.PRESENT)
    profiles, hm5, re5 = args[:4], args[4], args[5]
    for i in range(len(cosp.PRESENT)):
        assert (hm5[i] > 1e-12).any(), cosp.PRESENT[i]
    hm9 = torch.zeros((cosp.N_HYDRO,) + hm5.shape[1:])
    re9 = torch.zeros_like(hm9)
    hm9[list(cosp.PRESENT)] = hm5
    re9[list(cosp.PRESENT)] = re5
    return profiles, hm5, re5, hm9, re9


@pytest.mark.parametrize("do_ray", [False, True])
def test_present_classes_equal_all_nine(radar_args, do_ray):
    profiles, hm5, re5, hm9, re9 = radar_args
    nine = qb.quickbeam_simulator(*profiles, hm9, re9, do_ray=do_ray)
    five = qb.quickbeam_simulator(*profiles, hm5, re5, do_ray=do_ray,
                                  classes=cosp.PRESENT)
    assert set(five) == set(nine)
    for k in nine:
        assert torch.equal(five[k], nine[k]), k
    assert (five["dbze"] > -30.0).any()


def test_graupel_zero_equals_four_classes(radar_args):
    profiles, hm5, re5, _, _ = radar_args
    hm5 = hm5.clone()
    hm5[-1] = 0.0
    five = qb.quickbeam_simulator(*profiles, hm5, re5, do_ray=True,
                                  classes=cosp.PRESENT)
    four = qb.quickbeam_simulator(*profiles, hm5[:4], re5[:4], do_ray=True,
                                  classes=cosp.PRESENT[:4])
    for k in five:
        assert torch.equal(five[k], four[k]), k


def test_classes_must_match_the_planes(radar_args):
    profiles, hm5, re5, _, _ = radar_args
    with pytest.raises(ValueError, match="4 classes for 5 hm"):
        qb.quickbeam_simulator(*profiles, hm5, re5, classes=(0, 1, 2, 3))
