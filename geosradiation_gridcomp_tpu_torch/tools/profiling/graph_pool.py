"""The private pool of the captured RRTMGP refresh on one NVIDIA GPU: its
segments by size, and which allocations opened them.

    python -m geosradiation_gridcomp_tpu_torch.tools.profiling.graph_pool
        [--ncol 8100] [--plain-draws]

Captures radiation_refresh with the RRTMGP SW and LW schemes through the
RRTMG-reduced facade on the port's example scene (scene.example_inputs,
72 levels, doy 172, 12 UTC) in a fresh process, with the caching
allocator's history recorded, and prints: the pool's segments (count,
GiB, by size), the bytes allocated at the peak and reserved, and the
segments the capture opened by size and the innermost frame of the port
that asked for them. --plain-draws runs the McICA draws
(models/rrtmgp/scheme.py:_gen_max_ran_mask) on their plain body, under
kernels.twins.twins, instead of kernel K8, everything else as it is, so that two runs compare the pool
with and without K8. The caching allocator's settings
(PYTORCH_CUDA_ALLOC_CONF) are the process's. Raises without a CUDA
device.
"""

import argparse
import collections

import torch

from ...config import RadiationConfig, Scheme
from ...driver.step import radiation_refresh
from ...kernels.twins import twins
from ...models.rrtmg.lw import RRTMGLW
from ...models.rrtmg.sw import RRTMGSW
from ...models.rrtmgp import scheme
from ...scene import example_inputs
from .timing import card

NLEV = 72
DOY, UTC = 172.0, 12.0


def opened_by(snapshot, addresses):
    """(MiB, innermost port frame) -> segments opened, of the segments at
    addresses: the last segment_alloc of the recorded history at each (an
    address freed and opened again counts once, as it is now)."""
    last = {}
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "segment_alloc" and ev["addr"] in addresses:
            last[ev["addr"]] = ev
    out = collections.Counter()
    for ev in last.values():
        port = [f for f in ev.get("frames", [])
                if "geosradiation_gridcomp_tpu_torch" in f["filename"]
                and not f["filename"].endswith("compiled.py")]
        where = (f"{port[0]['filename'].split('_torch/')[-1]}:"
                 f"{port[0]['line']} {port[0]['name']}") if port else "?"
        out[(round(ev["size"] / 2**20), where)] += 1
    return out


def run(dev, ncol, plain_draws=False):
    """Capture the refresh at ncol columns; returns the pool's segments
    (the allocator's snapshot entries) and the opened_by counter."""
    if plain_draws:
        body = scheme._gen_max_ran_mask

        def draws_on_twin(*args):
            with twins():
                return body(*args)
        scheme._gen_max_ran_mask = draws_on_twin
    inp = example_inputs(ncol, NLEV, seed=0, device=dev)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    mods = dict(sw=RRTMGSW.from_reference_tables(dev),
                lw=RRTMGLW.from_reference_tables(dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=400000)
    try:
        radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict, icb=icb,
                          **mods)
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    segs = [s for s in snapshot["segments"]
            if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0)]
    return segs, opened_by(snapshot, {s["address"] for s in segs})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, default=8100)
    ap.add_argument("--plain-draws", action="store_true",
                    help="the McICA draws on their plain body, not K8")
    args = ap.parse_args(argv)
    dev, _ = card()
    segs, opened = run(dev, args.ncol, args.plain_draws)
    sizes = collections.Counter(round(s["total_size"] / 2**20) for s in segs)
    print(f"RRTMGP refresh at {args.ncol} x {NLEV}, draws "
          f"{'plain' if args.plain_draws else 'K8'}: graph pool "
          f"{len(segs)} segments, "
          f"{sum(s['total_size'] for s in segs) / 2**30:.3f} GiB; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    print("  segments, MiB x count: "
          + ", ".join(f"{m} x {n}" for m, n in
                      sorted(sizes.items(), key=lambda kv: -kv[0] * kv[1])))
    print("  opened by (MiB, the port's frame), the largest totals first:")
    for (mib, where), n in sorted(opened.items(),
                                  key=lambda kv: -kv[0][0] * kv[1])[:24]:
        print(f"    {mib:6d} MiB x {n:3d}  {where}")


if __name__ == "__main__":
    main()
