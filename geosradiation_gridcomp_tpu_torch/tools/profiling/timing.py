"""CUDA-event timing for the profiling tools.

The port's counterpart of the reference's tools/profiling/timing2.py
(bench_loop, bench_carry, report). There, K iterations ran inside one
jitted loop and a fixed dispatch floor was subtracted; here each round is
K back-to-back calls between two CUDA events on the current stream, after
a warm-up call, and the median round gives the time per call. Times are
device times in milliseconds on the card that card() names.
"""

import statistics
import subprocess

import torch


def card():
    """The CUDA device the tools measure on, and the card's name and power
    limit as nvidia-smi gives them (printed, as every number the tools
    print is for that card). Raises where there is no CUDA device: the
    tools have no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("this tool measures on a CUDA device and there "
                           "is none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0), smi


def _rounds(step, k, n):
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def bench_loop(fn, *args, k=10, n=3):
    """Median ms per call of fn(*args) over n rounds of k calls."""
    fn(*args)
    torch.cuda.synchronize()
    return _rounds(lambda: fn(*args), k, n)


def bench_carry(fn, x0, k=10, n=3):
    """Median ms per iteration where fn's output is its next input, so
    every output is produced and read."""
    box = [fn(x0)]
    torch.cuda.synchronize()

    def step():
        box[0] = fn(box[0])
    return _rounds(step, k, n)


def report(name, ms, ncol):
    """One line: the name, ms per call and columns per second."""
    print(f"{name:44s} {ms:9.3f} ms  {ncol / (ms * 1e-3):12.0f} cols/s")
