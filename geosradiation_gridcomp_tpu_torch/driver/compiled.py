"""The counterpart of jax.jit for the port's entry points: CUDA graphs.

The reference wraps its entry points in jax.jit with static arguments:
the step's radiation_refresh and radiation_update
(geosradiation_gridcomp_tpu/driver/step.py:20-22, 59), the schemes'
rrtmg_lw / rrtmg_sw, chou_sw / chou_lw and rrtmgp_sw / rrtmgp_lw, and the
satellite simulators' cosp_simulator (satsim/cosp.py:143; the
simulators' own jits trace into it). Each static key is traced and
compiled once, and every later call copies in its traced arguments and
dispatches one program. Here `captured(body, static_argnames=...)` does
the same on a card:

- the key is the static arguments' values (`config`, a RadiationConfig
  or a SatsimConfig, is a frozen dataclass, as for jit) plus the
  structure of the traced ones: for each tensor its shape, dtype and
  device, a scalar (a Python number or a 0-d floating tensor: `doy`,
  `utc_hours`) as such, and where each None, tuple or NamedTuple stands
  (`sw_aero`, `lw_aero`, the states, SatsimInputs);
- the first call with a key allocates static input buffers (a scalar
  becomes a 0-d float32 device tensor), copies the call's values in,
  warms the body up on them on a side stream (which fills the
  per-device caches of tables, sets kernel attributes and builds
  modules) and captures it on them with torch.cuda.graph; every key of
  a device shares one memory pool and one capture stream;
- every call copies its traced tensors into the buffers and fills the
  scalars on the current stream, replays the graph there and returns
  clones of the static outputs: the clones keep jit's value semantics (a
  state kept across heartbeats is not overwritten by the next replay)
  and make the shared pool safe for sequential replays on one stream.

A route function decides from the bound arguments whether a call takes
the graph at all (CPU tensors and the plain twins run the body eagerly,
as the caller asked) and may complete them (the refresh fills in its
table modules, cosp_simulator its default config). A capture that fails
raises; nothing falls back to the eager body. Every static value must
hash.

Nesting: a jit called inside another jit traces into its caller, and so
here a captured entry called while another entry's body warms up or is
captured runs its own body and records no graph (the refresh's graph
then holds rrtmg_lw's kernels, and rrtmg_lw keeps no graph of its own).
`disable_capture()` makes every entry called inside it run its body
(jax.disable_jit's counterpart): what records the kernel wrappers'
calls must run under it, since a replay calls no Python wrapper. So does
kernels.twins.twins(), which a plain=True body opens: an entry a plain
body reaches never captures.

kernels.build.LAUNCHES counts each kernel once per call on either route:
the wrapper calls made during the warm-up and the capture are taken back
out, and each replay adds what its capture recorded.

What a call costs on the host: every call that takes the graph keeps
time.perf_counter stamps at the boundaries of its phases in a ring of
floats written in place (`recent_calls()` reads it as CallRecords: the
entry, a call id, the key's id, the phases and their stamps): `bind`
(arguments bound, routed and keyed), `capture` (a new key's static
buffers, warm-up and capture), `copy_in` (StaticIO.load), `replay`
(graph.replay and its LAUNCHES update) and `clone_out`. Only while a
torch.profiler records does each phase also become a range
"<entry>/<phase>" (`radiation_update/copy_in`), so that a trace can name
what the host did while the device idled; the `bind` range opens once
the route has sent the call to its graph, so an eager call opens none.
Nothing of it runs inside a graph, reads a tensor back or synchronises;
a nested or eager call records nothing. `counts()` gives, per entry, the
host seconds of its captures and, per key, the copies a call makes
(tensors copied in, scalars filled or copied, tensors cloned out).
"""

import contextlib
import functools
import inspect
import itertools
import numbers
import struct
import threading
import time
import weakref
from typing import NamedTuple

import torch

from ..kernels.build import LAUNCHES
from ..kernels.twins import active as twins_active
from ..parallel.sharding import tree_leaves, tree_map

# the structure of a traced leaf
TENSOR, SCALAR = "tensor", "scalar"

# how many bodies of captured entries are being warmed up or captured
# (or disable_capture blocks entered) on this thread
_NESTING = threading.local()


def _depth():
    return getattr(_NESTING, "depth", 0)


class CallRecord(NamedTuple):
    """One captured call: phases[i] ran from stamps[i] to stamps[i + 1]
    (time.perf_counter seconds)."""
    entry: str
    call: int
    key: int
    phases: tuple
    stamps: tuple

    def durations(self):
        """Seconds of each phase, by name."""
        return {p: b - a for p, a, b in
                zip(self.phases, self.stamps, self.stamps[1:])}


PHASES = ("bind", "capture", "copy_in", "replay", "clone_out")
REPLAYED = tuple(p for p in PHASES if p != "capture")

# The ring of captured calls, about 30 s of the heartbeat loop's ~280
# calls a second: call i's slot is i % _SLOTS, _ENTRY_OF[slot] its entry's
# name, and the slot's _SLOT.size bytes of _STAMPS its key's id and six
# stamps as doubles: at the call, the key found, the capture done (the
# key found again when the call captured nothing), and copy-in, replay
# and clone-out done.
_SLOTS, _SLOT = 1 << 14, struct.Struct("7d")
_ENTRY_OF = [None] * _SLOTS
_STAMPS = bytearray(_SLOT.size * _SLOTS)
_CALLS = 0
_KEY_IDS = itertools.count()
_ENTRIES = weakref.WeakSet()
_profiling = torch._C._autograd._profiler_enabled


def _record(entry, key, t0, t1, t2, t3, t4, t5):
    """Keep one captured call in the ring."""
    global _CALLS
    slot = _CALLS % _SLOTS
    _CALLS += 1
    _ENTRY_OF[slot] = entry
    _SLOT.pack_into(_STAMPS, slot * _SLOT.size, key, t0, t1, t2, t3, t4, t5)


def recent_calls():
    """The CallRecords of the latest captured calls, oldest first."""
    out = []
    for call in range(max(0, _CALLS - _SLOTS), _CALLS):
        slot = call % _SLOTS
        key, *stamps = _SLOT.unpack_from(_STAMPS, slot * _SLOT.size)
        phases = PHASES
        if stamps[2] == stamps[1]:
            del stamps[2]
            phases = REPLAYED
        out.append(CallRecord(_ENTRY_OF[slot], call, int(key), phases,
                              tuple(stamps)))
    return tuple(out)


def counts():
    """Captured.counts() of every captured entry, by entry name."""
    return {entry.__name__: entry.counts() for entry in list(_ENTRIES)}


class _Ranges:
    """While a profiler records: a range "<entry>/<phase>" over each phase
    of one captured call, each ending where the next begins."""

    __slots__ = ("entry", "open")

    def __init__(self, entry):
        self.entry, self.open = entry, None
        self.begin("bind")

    def begin(self, phase):
        self.end()
        self.open = torch.profiler.record_function(f"{self.entry}/{phase}")
        self.open.__enter__()

    def end(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


@contextlib.contextmanager
def disable_capture():
    """Within the block every captured entry runs its body eagerly and
    records no graph (jax.disable_jit's counterpart). The warm-up and the
    capture of a body run under it, so nested entries trace into their
    caller."""
    _NESTING.depth = _depth() + 1
    try:
        yield
    finally:
        _NESTING.depth -= 1


def _is_scalar(x):
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 and x.is_floating_point()
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def flatten(tree, leaves):
    """The structure of a traced argument, appending its leaves (tensors
    and scalars) to leaves: SCALAR, (TENSOR, shape, dtype, device), None,
    or (container type, structures of the items)."""
    if _is_scalar(tree):
        leaves.append(tree)
        return SCALAR
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (TENSOR, tuple(tree.shape), tree.dtype, tree.device)
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(flatten(x, leaves) for x in tree))
    raise TypeError(f"captured: cannot trace an argument of type "
                    f"{type(tree).__name__}")


def unflatten(structure, leaves):
    """The traced argument of that structure on the leaves (an iterator)."""
    if structure is None:
        return None
    if structure == SCALAR or structure[0] == TENSOR:
        return next(leaves)
    typ, items = structure
    values = [unflatten(s, leaves) for s in items]
    return typ(*values) if hasattr(typ, "_fields") else typ(values)


def clone_tree(tree):
    """A copy of every tensor of the tree, in a tree of the same form."""
    return tree_map(lambda t: t.clone(), tree)


class StaticIO:
    """The static input buffers of one key and the copy-in / clone-out
    around a replay.

    traced: name -> value of each traced argument of the call that makes
    the key; device: where the buffers live (every tensor of traced but
    the scalars must lie there). `load` copies another call's traced
    values into the buffers on the current stream (fill_ for a Python
    number); Captured.__call__ then replays and returns clone_tree of the
    static outputs. `arguments` are the traced arguments on the buffers,
    which the body is captured on.
    """

    def __init__(self, traced, device):
        leaves = []
        self.structures = {n: flatten(v, leaves) for n, v in traced.items()}
        stray = {x.device for x in leaves if not _is_scalar(x)} - {device}
        if stray:
            raise ValueError(f"captured: the traced tensors lie on {device} "
                             f"and {sorted(map(str, stray))}")
        self.buffers = [
            torch.zeros((), dtype=torch.float32, device=device)
            if _is_scalar(x) else torch.empty(x.shape, dtype=x.dtype,
                                              device=device)
            for x in leaves]
        self.scalars = sum(map(_is_scalar, leaves))
        it = iter(self.buffers)
        self.arguments = {n: unflatten(s, it)
                          for n, s in self.structures.items()}

    def load(self, traced):
        """Copy the traced values into the buffers."""
        leaves = []
        for name, value in traced.items():
            flatten(value, leaves)
        for buf, x in zip(self.buffers, leaves):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            else:
                buf.fill_(float(x))


@functools.lru_cache(maxsize=None)
def graph_pool(device):
    """(memory pool handle, capture stream) shared by every graph captured
    on device."""
    return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)


class _Graph:
    """One captured key: its StaticIO, graph, static outputs, the
    launches its capture recorded, its id and the copies a call of it
    makes."""

    def __init__(self, body, bound, io, device):
        bound.arguments.update(io.arguments)
        before = dict(LAUNCHES)
        try:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side), disable_capture():
                body(*bound.args, **bound.kwargs)
            current.wait_stream(side)
            warm = dict(LAUNCHES)
            pool, stream = graph_pool(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream), \
                    disable_capture():
                self.out = body(*bound.args, **bound.kwargs)
            self.launches = {k: n - warm.get(k, 0)
                             for k, n in LAUNCHES.items()
                             if n != warm.get(k, 0)}
        finally:
            LAUNCHES.clear()
            LAUNCHES.update(before)
        self.io = io
        self.id = next(_KEY_IDS)
        self.copies = dict(copies=len(io.buffers) - io.scalars,
                           fills=io.scalars,
                           clones=len(tree_leaves(self.out)))

    def replay(self):
        self.graph.replay()
        LAUNCHES.update(self.launches)
        return self.out


def _first_device(tree):
    """The device of the first tensor (not 0-d) of a traced argument."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.dim() > 0 else None
    if isinstance(tree, (tuple, list)):
        for x in tree:
            device = _first_device(x)
            if device is not None:
                return device
    return None


def on_card(arguments, device):
    """The default route: capture where the traced tensors lie on a card."""
    return arguments if device is not None and device.type == "cuda" \
        else None


def with_kernels(arguments, device):
    """The route of the entries with a plain switch: capture on a card
    unless plain, whose body runs the plain twins (kernels.twins), what
    the kernels are held to."""
    return None if arguments["plain"] else on_card(arguments, device)


class Captured:
    """body as a captured entry: see the module docstring.

    route(arguments, device) gets the bound arguments (name -> value,
    defaults applied) and the device of the traced tensors, and returns
    None to run the body eagerly, or the arguments to capture and replay
    with (it may fill some of the static ones in)."""

    def __init__(self, body, static_argnames, route=on_card):
        self.body = body
        self.static_argnames = tuple(static_argnames)
        self.route = route
        self.signature = inspect.signature(body)
        self.graphs = {}
        self.capture_s = 0.0
        functools.update_wrapper(self, body)
        self.__name__ = body.__name__.removesuffix("_eager")
        _ENTRIES.add(self)

    def traced(self, arguments):
        return {n: v for n, v in arguments.items()
                if n not in self.static_argnames}

    def key(self, arguments):
        """The cache key of a call's arguments (bound, defaults applied):
        the static values and the traced arguments' structures."""
        static = tuple((n, arguments[n]) for n in self.static_argnames)
        for name, value in static:
            try:
                hash(value)
            except TypeError:
                raise TypeError(
                    f"{self.__name__}: the static argument {name} must "
                    f"hash, not {type(value).__name__} (pass a tuple)"
                ) from None
        leaves = []
        return static, tuple((n, flatten(v, leaves))
                             for n, v in self.traced(arguments).items())

    def counts(self):
        """The host seconds of every capture of this entry (StaticIO,
        warm-up and capture; dropped keys too), and per live key, by its
        id, the copies a call makes: tensors copied in, scalars filled or
        copied, tensors cloned out."""
        return dict(capture_s=self.capture_s,
                    keys={g.id: dict(g.copies) for g in self.graphs.values()})

    def __call__(self, *args, **kwargs):
        if _depth() or twins_active():
            return self.body(*args, **kwargs)
        t0 = time.perf_counter()
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        traced = self.traced(bound.arguments)
        device = next((d for d in map(_first_device, traced.values())
                       if d is not None), None)
        arguments = self.route(dict(bound.arguments), device)
        if arguments is None:
            return self.body(*args, **kwargs)
        ranges = _Ranges(self.__name__) if _profiling() else None
        try:
            key = self.key(arguments)
            graph = self.graphs.get(key)
            t1 = t2 = time.perf_counter()
            if graph is None:
                if ranges:
                    ranges.begin("capture")
                io = StaticIO(traced, device)
                io.load(traced)
                bound.arguments.update(arguments)
                with torch.cuda.device(device):
                    graph = _Graph(self.body, bound, io, device)
                self.graphs[key] = graph
                t2 = time.perf_counter()
                self.capture_s += t2 - t1
            if ranges:
                ranges.begin("copy_in")
            graph.io.load(traced)
            t3 = time.perf_counter()
            if ranges:
                ranges.begin("replay")
            out = graph.replay()
            t4 = time.perf_counter()
            if ranges:
                ranges.begin("clone_out")
            out = clone_tree(out)
            t5 = time.perf_counter()
        finally:
            if ranges:
                ranges.end()
        _record(self.__name__, graph.id, t0, t1, t2, t3, t4, t5)
        return out


def captured(body, static_argnames, route=on_card):
    """body as an entry that captures one CUDA graph per static key and
    replays it (the counterpart of jax.jit(body, static_argnames=...));
    see the module docstring."""
    return Captured(body, static_argnames, route)
