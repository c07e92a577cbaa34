"""The readings that the SATSIM cell's limits are set from, one JSON line
a seed:

    python3 benchmark/satsim_orders.py --workload cosp.satsim_c90 \
        --seeds <n> [<n> ...] --seconds 3 --points 512

For each seed, one run of the cell with a short window, then for every
sampled answer:
- `port`: the port's readings against the plain reference on the card
  (control.readings' first half);
- `control`: the control's (the reference as a bfloat16 program would
  compute it) against the same reference;
- `orders`: the SATSIM numbers of a sound computation in another float
  order: the port's COSP answer on the card against the reference run
  on the CPU, on the sample's first `points` points (both their own call
  with the sample's key, since SCOPS draws over all the points of a
  call).
A SATSIM limit lies above the largest `orders` reading and below the
smallest `control` reading. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import harness  # noqa: E402
import program  # noqa: E402
import satsim_scene  # noqa: E402
from reference.compare import worst  # noqa: E402
from reference.satsim import (COUNTS, NUMBERS, albedo,  # noqa: E402
                              compare_satsim, field_relmax, is_fill,
                              leaves)


def orders(loop, points):
    """The SATSIM numbers of the port's card answer against the
    reference's CPU answer on the first `points` points of each sample."""
    import torch
    from reference.rt.satsim.cosp import SatsimConfig, SatsimInputs
    from reference.rt.satsim.cosp import cosp_simulator_eager as ref_cosp
    from reference.rt.satsim.scops import prec_scops as ref_prec
    cfg = SatsimConfig(**loop.cell.config["satsim"])
    out = []
    for item in loop.samples.items:
        k = item["k"]
        head = {n: x[:points] for n, x in loop.base.items()}
        mcosz = satsim_scene.mcosz(loop.arrays, *loop.alarms[k],
                                   loop.cell.config["solar_dt"],
                                   loop.device)[:points]
        key = satsim_scene.key(loop.seed, k, len(loop.alarms), loop.device)
        card = loop._cosp(key, loop._satsim_inputs(
            **head, mcosz=mcosz), loop.satsim_cfg)
        card = dict(card, prec_frac=loop._prec_scops(
            head["qr"] + head["qs"] + head["qg"],
            torch.zeros_like(head["qr"]), card["frac_out"]))
        inp = SatsimInputs(**{n: x.cpu() for n, x in head.items()},
                           mcosz=mcosz.cpu())
        cpu = ref_cosp(key.cpu(), inp, cfg)
        cpu["prec_frac"] = ref_prec(inp.qr + inp.qs + inp.qg,
                                    torch.zeros_like(inp.qr),
                                    cpu["frac_out"])
        out.append(compare_satsim(_cpu(card), cpu))
        worst_field = max(fields(_cpu(card), cpu).items(),
                          key=lambda kv: kv[1])
        if worst_field[1] > 0.0:
            out[-1] = dict(out[-1], worst_field=worst_field)
    return worst([{n: v for n, v in r.items() if n in NUMBERS}
                  for r in out]), [r.get("worst_field") for r in out]


def fields(got, want):
    """Each float field's relmax as satsim_relmax takes it, by name (the
    counts left out)."""
    pairs = dict(leaves(got))
    out = {}
    for name, w in leaves(want):
        if not w.is_floating_point() or name.rsplit("/", 1)[-1] in COUNTS:
            continue
        g = pairs[name]
        keep = ~(is_fill(g) | is_fill(w))
        g, w = g[keep], w[keep]
        if name.endswith("meantaucld"):
            g, w = albedo(g), albedo(w)
        out[name] = field_relmax(g, w)
    return out


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()


def readings(cell, seed, seconds, points, device="cuda"):
    loop = harness.driver_of(cell).Loop(cell, seed, harness.Spans(), device)
    loop.run(seconds, harness.Stretch(None, 0, 0, False))
    program.sync(device)
    loop.release()
    pairs = loop.answers(loop.reference())
    port = worst([loop.compare(g, w) for g, w in pairs])
    ctrl = loop.answers(loop.reference(control=True))
    control = worst([loop.compare(c, w)
                     for (_, c), (_, w) in zip(ctrl, pairs)])
    del pairs, ctrl
    numbers, worst_fields = orders(loop, points)
    return dict(port=port, control=control, orders=numbers,
                worst_fields=worst_fields)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="cosp.satsim_c90")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--points", type=int, default=512)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_chip(cell.entry["chips"])
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, args.points)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
