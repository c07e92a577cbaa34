"""Micro-benchmark of table-gather formulations on one NVIDIA GPU.

    python -m geosradiation_gridcomp_tpu_torch.tools.profiling.gather_micro
        [--n 589824] [--rows 585]

Port of the reference's tools/profiling/gather_micro.py. The taumol
kernels, setcoef and the cloud band coefficients are built on
out[p, :] = tab[idx[p], :] for a small table (65..585 rows x 16 columns)
at N = ncol x nlay points. At the reference's sizes (N = 8192 x 72,
585 rows, 16 columns, a random float table and indices from seed 0) this
times, per call: the plain formulations tab[idx] and index_select, a
one-hot float32 matmul (TF32 off; a plain timing only) and the two P2
kernels of ops/gather_cuda.py with their twins: gather_rows (tab[idx]
with float4 streaming stores, the table through the read-only path) and
gather_lanes (the reference's transposed lane gather, the table resident
in shared memory). Prints ms, Mpts/s and the output's GB/s; raises if a
kernel differs from its twin or without a CUDA device.
"""

import argparse

import torch

from ...ops.gather_cuda import (gather_lanes, gather_lanes_plain,
                                gather_rows, gather_rows_plain)
from .timing import bench_loop, card

NG = 16


def run(dev, n=8192 * 72, rows=585, k=20, reps=3):
    """Every formulation at n points; returns {name: ms}."""
    gen = torch.Generator(dev).manual_seed(0)
    tab = torch.randn(rows, NG, device=dev, generator=gen)
    rows_pad = (rows + 127) // 128 * 128
    tab_t = torch.nn.functional.pad(tab.T, (0, rows_pad - rows)).contiguous()
    idx = torch.randint(0, rows - 1, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    idx2d = idx.reshape(-1, 128)
    idx64 = idx.long()

    if not torch.equal(gather_rows(idx, tab), gather_rows_plain(idx, tab)):
        raise AssertionError("gather_rows differs from tab[idx]")
    if not torch.equal(gather_lanes(idx2d, tab_t),
                       gather_lanes_plain(idx2d, tab_t)):
        raise AssertionError("gather_lanes differs from its twin")

    forms = {
        "plain tab[idx] (rows,16)": lambda: tab[idx64],
        "index_select axis0": lambda: torch.index_select(tab, 0, idx64),
        "one-hot matmul f32": lambda: torch.nn.functional.one_hot(
            idx64, rows).float() @ tab,
        "kernel gather_rows": lambda: gather_rows(idx, tab),
        "plain lanes tabT[:, idx]": lambda: gather_lanes_plain(idx2d, tab_t),
        "kernel gather_lanes": lambda: gather_lanes(idx2d, tab_t),
    }
    print(f"N={n} ROWS={rows} NG={NG}")
    res = {}
    for name, fn in forms.items():
        ms = bench_loop(fn, k=k, n=reps)
        gbs = n * NG * 4 / (ms * 1e-3) / 1e9
        print(f"{name:34s} {ms:9.3f} ms  {n / (ms * 1e-3) / 1e6:9.1f} "
              f"Mpts/s  out {gbs:7.1f} GB/s")
        res[name] = ms
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192 * 72,
                    help="points (a multiple of 8192)")
    ap.add_argument("--rows", type=int, default=585)
    args = ap.parse_args(argv)
    dev, _ = card()
    return run(dev, args.n, args.rows)


if __name__ == "__main__":
    main()
