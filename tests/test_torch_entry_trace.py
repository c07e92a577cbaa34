"""The captured entries' record of their own calls (driver/compiled.py) on
the CPU, with torch.cuda's stream and graph API stood in for
(test_torch_step_capture._fake_cuda): one CallRecord per call that takes
the graph, its phases in order under one call id; the first call of a
key records its capture and adds its seconds to the entry's; nested and
eager calls record nothing; counts() per key; the ring keeps its last
calls in order; the "<entry>/<phase>" ranges only while a profiler
records, and none for an eager call; no tensor read back on a replayed
call."""

import collections
import json
from typing import NamedTuple

import pytest
import torch

from geosradiation_gridcomp_tpu_torch.driver import compiled
from geosradiation_gridcomp_tpu_torch.driver.compiled import (
    Captured, disable_capture)
from test_torch_step_capture import _counting, _fake_cuda

REPLAYED = ("bind", "copy_in", "replay", "clone_out")
FIRST = ("bind", "capture", "copy_in", "replay", "clone_out")


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: object


def toy_eager(x, s, pair, *, k):
    """Tensors, a scalar and a NamedTuple in; a NamedTuple and a dict of
    tensors out."""
    y = x * s + pair.a
    return Pair(y, y + pair.b, None), dict(z=x + k, w=pair.b * 2.0)


def _entry(route=lambda arguments, device: arguments):
    return Captured(toy_eager, ("k",), route=route)


def _args(shift=0.0, scalar=2.0):
    x = torch.arange(6.0).reshape(2, 3) + shift
    return x, scalar, Pair(x + 1.0, x - 1.0, None)


def _mine(entry):
    return [r for r in compiled.recent_calls() if r.entry == entry.__name__
            and r.key in {g.id for g in entry.graphs.values()}]


def _last_call():
    recent = compiled.recent_calls()
    return recent[-1].call if recent else -1


def _since(last):
    return [r for r in compiled.recent_calls() if r.call > last]


def test_one_record_per_call_with_its_phases_in_order(monkeypatch):
    _fake_cuda(monkeypatch)
    entry = _entry()
    assert entry.__name__ == "toy"
    for i in range(3):
        entry(*_args(i, torch.tensor(2.0 + i)), k=1)
    first, *rest = _mine(entry)
    assert len(rest) == 2
    assert first.phases == FIRST and all(r.phases == REPLAYED for r in rest)
    assert len({r.key for r in (first, *rest)}) == 1
    calls = [r.call for r in (first, *rest)]
    assert calls == sorted(set(calls))
    for r in (first, *rest):
        assert len(r.stamps) == len(r.phases) + 1
        assert list(r.stamps) == sorted(r.stamps)
        assert set(r.durations()) == set(r.phases)
    assert rest[0].stamps[0] >= first.stamps[-1]
    c = entry.counts()
    assert c["capture_s"] == first.durations()["capture"] > 0.0
    assert list(c["keys"]) == [first.key]


def test_a_new_key_captures_and_counts_again(monkeypatch):
    _fake_cuda(monkeypatch)
    entry = _entry()
    entry.__name__ = "toy_keys"
    entry(*_args(), k=1)
    entry(*_args(), k=2)
    entry(*_args(), k=2)
    records = _mine(entry)
    assert [r.phases for r in records] == [FIRST, FIRST, REPLAYED]
    assert records[1].key == records[2].key != records[0].key
    c = entry.counts()
    assert sorted(c["keys"]) == sorted({r.key for r in records})
    assert c["capture_s"] == pytest.approx(
        sum(r.durations()["capture"] for r in records[:2]))
    assert compiled.counts()["toy_keys"] == c


def test_nested_and_eager_calls_record_nothing(monkeypatch):
    _fake_cuda(monkeypatch)
    inner = Captured(toy_eager, ("k",), route=lambda a, d: a)
    inner.__name__ = "inner"

    def outer_eager(x, s, pair, *, k):
        return inner(x, s, pair, k=k)

    outer = Captured(outer_eager, ("k",), route=lambda a, d: a)
    eager = _entry(route=lambda arguments, device: None)
    last = _last_call()
    outer(*_args(), k=1)
    outer(*_args(), k=1)
    with disable_capture():
        inner(*_args(), k=1)
    eager(*_args(), k=1)
    eager(*_args(), k=1)
    assert [r.entry for r in _since(last)] == ["outer", "outer"]
    assert inner.counts() == dict(capture_s=0.0, keys={})
    assert eager.counts() == dict(capture_s=0.0, keys={})
    assert len(outer.counts()["keys"]) == 1


@pytest.mark.parametrize("scalar", [2.0, torch.tensor(2.0)],
                         ids=["float", "tensor"])
def test_counts_give_replays_and_copies_per_call(monkeypatch, scalar):
    """x and pair's two tensors copied in, s filled (a Python number) or
    copied (a 0-d tensor), and the four output tensors cloned out."""
    _fake_cuda(monkeypatch)
    entry = _entry()
    for i in range(4):
        entry(*_args(i, scalar), k=1)
    ((key, copies),) = entry.counts()["keys"].items()
    assert [r.key for r in _mine(entry)] == [key] * 4
    assert copies == dict(copies=3, fills=1, clones=4)


def test_phases_are_profiler_ranges_only_under_a_profiler(monkeypatch,
                                                          tmp_path):
    from torch.profiler import ProfilerActivity, profile

    _fake_cuda(monkeypatch)
    entry = _entry()
    eager = _entry(route=lambda arguments, device: None)
    eager.__name__ = "toy_eager_route"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry(*_args(), k=1)
        eager(*_args(), k=1)
        entry(*_args(1.0), k=1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    events = [e for e in spans if str(e["name"]).startswith("toy/")]
    assert not [e for e in spans
                if str(e["name"]).startswith("toy_eager_route/")]
    assert {e["cat"] for e in events} == {"user_annotation"}
    assert collections.Counter(e["name"] for e in events) == \
        collections.Counter(f"toy/{p}" for p in FIRST + REPLAYED)

    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    before = len(_mine(entry))
    entry(*_args(2.0), k=1)
    entry(*_args(), k=3)
    assert len(_mine(entry)) == before + 2


def test_a_replayed_call_reads_nothing_back(monkeypatch):
    _fake_cuda(monkeypatch)
    entry = _entry()
    entry(*_args(0.0, torch.tensor(2.0)), k=1)
    calls = [_args(1.0, torch.tensor(3.0)), _args(2.0, 4.0)]
    found = _counting(monkeypatch)
    for args in calls:
        entry(*args, k=1)
    assert found == []
    assert [r.phases for r in _mine(entry)][-2:] == [REPLAYED, REPLAYED]


def test_a_failed_capture_leaves_no_range_open(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    _fake_cuda(monkeypatch)

    def broken_eager(x, s, pair, *, k):
        raise RuntimeError("capture refused")
    entry = Captured(broken_eager, ("k",), route=lambda a, d: a)
    last = _last_call()
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(1)
            return super().__enter__()

        def __exit__(self, *exc):
            entered.pop()
            return super().__exit__(*exc)
    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="capture refused"):
            entry(*_args(), k=1)
        assert entered == []
    assert _since(last) == []
    assert entry.counts() == dict(capture_s=0.0, keys={})


def test_the_ring_keeps_its_last_calls_in_order(monkeypatch):
    """A ring of 4 slots after 6 calls: the last 4, oldest first, with
    consecutive call ids."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(compiled, "_SLOTS", 4)
    monkeypatch.setattr(compiled, "_ENTRY_OF", [None] * 4)
    monkeypatch.setattr(compiled, "_STAMPS",
                        bytearray(compiled._SLOT.size * 4))
    monkeypatch.setattr(compiled, "_CALLS", 0)
    entry = _entry()
    for i in range(6):
        entry(*_args(i), k=1)
    records = compiled.recent_calls()
    assert [r.call for r in records] == [2, 3, 4, 5]
    assert [r.phases for r in records] == [REPLAYED] * 4
    assert all(r.entry == "toy" for r in records)
    assert all(a.stamps[-1] <= b.stamps[0]
               for a, b in zip(records, records[1:]))
