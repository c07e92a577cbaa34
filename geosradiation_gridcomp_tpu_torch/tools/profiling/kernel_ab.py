"""Time the step kernels (K1-K6) of one checkout on the refresh's own
inputs, for an A/B of two checkouts on one card.

    python geosradiation_gridcomp_tpu_torch/tools/profiling/kernel_ab.py \
        [--tree PATH] [--label NAME] [--rounds 5] [--k 20]

Run as a file, not with -m: --tree names the root of the checkout whose
package `geosradiation_gridcomp_tpu_torch` is timed (default: the checkout
holding this file), so an unpacked archive of another commit is timed with
this same script. Run parent, change, change, parent in one call and
compare within it.

The inputs are those of one radiation_refresh at 8192 columns x 72
levels on the scene of scene.example_inputs (seed 0), doy 172, 12 UTC,
with bench.py's sw_partition_bounds packing: each step kernel's wrapper
is recorded as the refresh calls it (`recording`, which chip_smoke.py
uses too). Each of the six is then timed with CUDA events, the median
of --rounds rounds of --k back-to-back calls, held once against its
plain twin (relmax, max|a - b| / max|b|, worst output), called once
under torch.cuda.set_sync_debug_mode("error") (`sync_free`: true, or the
error a synchronising call raised), and profiled over 5 calls
(torch.profiler: `kernel_ms`, the device time of the CUDA kernel itself
per call, and `other_device_ms`, that of everything else the wrapper
runs on the device: copies, PyTorch's own kernels).

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys

NCOL, NLEV, SEED, DOY, UTC = 8192, 72, 0, 172.0, 12.0
HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = "geosradiation_gridcomp_tpu_torch"

# the step kernels: name -> (scheme module that calls the wrapper, the
# wrapper's name there, the plain twin as module:function, the CUDA
# kernel's function name in csrc/)
STEP_KERNELS = {
    "mcica_optics_lw": ("lw", "mcica_optics_lw",
                        "ops.mcica_cuda:mcica_optics_lw_plain",
                        "mcica_lw_kernel"),
    "taumol_lw": ("lw", "taumol_lw_fast", "models.rrtmg.taumol_lw:taumol_lw",
                  "taumol_lw_kernel"),
    "rtrnmc": ("lw", "rtrnmc_fast", "models.rrtmg.rtrnmc:rtrnmc",
               "rtrnmc_kernel"),
    "mcica_optics_sw": ("sw", "mcica_optics_sw",
                        "ops.mcica_cuda:mcica_optics_sw_plain",
                        "mcica_sw_kernel"),
    "taumol_sw": ("sw", "taumol_sw_fast", "models.rrtmg.taumol_sw:taumol_sw",
                  "taumol_sw_kernel"),
    "spcvmc": ("sw", "spcvmc_fast", "models.rrtmg.spcvmc:spcvmc_sw",
               "spcvmc_kernel"),
}


def plain_twin(name):
    """The plain PyTorch twin of step kernel `name`."""
    mod, fn = STEP_KERNELS[name][2].split(":")
    return getattr(importlib.import_module(f"{_PKG}.{mod}"), fn)


@contextlib.contextmanager
def recording():
    """Within the block, each step kernel's wrapper, as the scheme modules
    (models/rrtmg/lw.py, sw.py) call it, keeps the arguments of its first
    call: yields kernel name -> (wrapper, args, kwargs)."""
    modules = {m: importlib.import_module(f"{_PKG}.models.rrtmg.{m}")
               for m in ("lw", "sw")}
    calls = {}

    def wrap(fn, name):
        def wrapper(*args, **kwargs):
            calls.setdefault(name, (fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapper
    saved = {}
    for name, (m, attr, *_) in STEP_KERNELS.items():
        saved[m, attr] = getattr(modules[m], attr)
        setattr(modules[m], attr, wrap(saved[m, attr], name))
    try:
        yield calls
    finally:
        for (m, attr), fn in saved.items():
            setattr(modules[m], attr, fn)


def tensors(out):
    """The tensors of a kernel's output (a tensor, tuple or dict), in
    order."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in tensors(x)]
    return [out] if hasattr(out, "shape") else []


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


def median_ms(torch, fn, k, rounds):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def sync_free(torch, run):
    """True if run() makes no call that synchronises the stream, else the
    error torch raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        return True
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def device_ms(torch, run, kernel, n=5):
    """(kernel's, everything else's) device time per call of run(), ms,
    from torch.profiler over n calls; kernel: the CUDA function's name."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    mine = other = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if kernel in e.key:
                mine += e.device_time_total
            else:
                other += e.device_time_total
    return mine / 1e3 / n, other / 1e3 / n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(HERE))))
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--k", type=int, default=20)
    args = parser.parse_args(argv)
    # import the package from --tree, not this file's directory
    sys.path[:] = [os.path.abspath(args.tree)] + [
        p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels import build
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build.library()
    dev = torch.device("cuda", 0)
    inp = example_inputs(NCOL, NLEV, seed=SEED, device=dev)
    cfg = RadiationConfig()
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, UTC, cfg)
              for d in (DOY, DOY + 0.01)]
    nlit, ncld = (None if any(b[i] is None for b in bounds)
                  else max(b[i] for b in bounds) for i in (0, 1))
    with recording() as calls:
        radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict, icb=icb,
                          sw_nlit=nlit, sw_ncld=ncld,
                          sw=swm.RRTMGSW.from_reference_tables(dev),
                          lw=lwm.RRTMGLW.from_reference_tables(dev))
        torch.cuda.synchronize()

    out = dict(label=args.label, card=smi.splitlines()[0])
    for name in STEP_KERNELS:
        fn, a, kw = calls[name]
        run = lambda: fn(*a, **kw)
        got, want = tensors(run()), tensors(plain_twin(name)(*a, **kw))
        out[name] = dict(
            out_shape=list(got[0].shape), ncld=kw.get("ncld"),
            relmax=max(relmax(x, y) for x, y in zip(got, want)),
            ms=median_ms(torch, run, args.k, args.rounds),
            sync_free=sync_free(torch, run))
        out[name]["kernel_ms"], out[name]["other_device_ms"] = device_ms(
            torch, run, STEP_KERNELS[name][3])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
