"""Multi-process scale-out: torch.distributed init + overlapped input
staging.

Port of geosradiation_gridcomp_tpu/parallel/distributed.py. The
reference's only cross-rank machinery is the ESMF VM/MPI communicator and
MAPL's balancer (GEOS_SolarGridComp.F90:3701-3712). Here each process
(rank) refreshes its own slice of the global columns (process_local_slice),
and a double-buffered host-to-device feed stages the inputs of step N+1
while step N computes (StagedFeed, run_steps_overlapped).
"""

import torch
import torch.distributed as dist

from .sharding import run_sharded, tree_leaves, tree_map


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           backend=None):
    """Bring up the process group (a no-op when single-process).

    Calls torch.distributed.init_process_group only when world_size > 1
    or init_method is given, with NCCL where there is a card and gloo
    otherwise (unless backend says). Call once on every process. Returns
    (rank, world_size); (0, 1) when single-process.
    """
    if world_size is not None and world_size > 1 \
            or init_method is not None:
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return _rank_and_size()


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_local_slice(ncol_global):
    """This process's [start, stop) column range for an evenly
    rank-sharded global column batch (each rank feeds only its local
    columns, like an MPI rank owning its IM x JM patch)."""
    p, n = _rank_and_size()
    per = ncol_global // n
    extra = ncol_global % n
    start = p * per + min(p, extra)
    return start, start + per + (1 if p < extra else 0)


class StagedFeed:
    """Double-buffered host-to-device input staging.

    put(inputs) copies the NEXT step's host inputs (numpy arrays or CPU
    tensors, in any tree) into pinned memory and starts their
    non-blocking copy on a side stream of each device, recording an event
    there, while the CURRENT step computes; get() makes the current
    stream wait on that event, marks the staged tensors as used by it
    (record_stream) and returns them. With a mesh the columns are split
    across its devices (shard_columns' split) and get() returns one tree
    per device. On the CPU it is a plain copy.
    """

    def __init__(self, mesh=None, device="cuda"):
        self._mesh = mesh
        self._devices = tuple(mesh) if mesh is not None \
            else (torch.device(device),)
        self._cuda = any(d.type == "cuda" for d in self._devices)
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError("StagedFeed: no CUDA device; pass a mesh of "
                               "CPU devices or device='cpu'")
        self._streams = {d: torch.cuda.Stream(d) for d in self._devices
                         if d.type == "cuda"}
        self._staged = None
        self._host = None

    def put(self, host_inputs):
        """Start the transfer of the next step's inputs."""
        n = len(self._devices)

        def stage(x):
            x = torch.as_tensor(x)
            return x.pin_memory() if self._cuda else x.clone()
        self._host = tree_map(stage, host_inputs)
        shards, events = [], []
        for i, d in enumerate(self._devices):
            def copy(x, i=i, d=d):
                return x.tensor_split(n)[i].to(d, non_blocking=True)
            if d.type != "cuda":
                shards.append(tree_map(copy, self._host))
                events.append(None)
                continue
            stream = self._streams[d]
            with torch.cuda.stream(stream):
                shards.append(tree_map(copy, self._host))
                ev = torch.cuda.Event()
                ev.record(stream)
            events.append(ev)
        self._staged = (shards, events)
        return self

    def get(self):
        """The staged device inputs, safe to use on the current stream."""
        if self._staged is None:
            raise RuntimeError("StagedFeed.get() before put()")
        (shards, events), self._staged = self._staged, None
        for shard, ev, d in zip(shards, events, self._devices):
            if ev is None:
                continue
            cur = torch.cuda.current_stream(d)
            cur.wait_event(ev)
            for t in tree_leaves(shard):
                t.record_stream(cur)
        return shards if self._mesh is not None else shards[0]


def run_steps_overlapped(step_fn, host_batches, mesh=None):
    """Drive step_fn over a sequence of host-resident input batches with
    stage-ahead: batch k+1 transfers while batch k computes. With a mesh,
    each batch is split across its devices and step_fn runs per shard
    (run_sharded). Returns the list of step outputs (device tensors).
    """
    feed = StagedFeed(mesh)
    step = step_fn if mesh is None \
        else (lambda shards: run_sharded(step_fn, shards))
    outs = []
    it = iter(host_batches)
    try:
        feed.put(next(it))
    except StopIteration:
        return outs
    for nxt in it:
        cur = feed.get()
        feed.put(nxt)                 # async: overlaps with step(cur)
        outs.append(step(cur))
    outs.append(step(feed.get()))
    return outs
