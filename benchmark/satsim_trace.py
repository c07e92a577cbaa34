"""What the SATSIM cell's per-layer metrics read: the benchmark's
`satsim` windows in the profiled stretch, the port's record of the
captured cosp_simulator calls inside its `satsim` spans before the
stretch (driver/compiled.py, through entry_trace), and the port's radar
counter (satsim/radar.py:counts). A port without such a record or
counter gives None, and so does a cell with no COSP call.
"""

import statistics

import entry_trace
import harness


def windows(ctx):
    """(start, end) of each COSP call in the stretch: its `satsim` span's
    start to the end of the sync that follows it."""
    return harness.unit_windows(ctx.trace, "satsim")


def device_ms(ctx):
    """Device ms of the operations that start in a window, per call."""
    w = windows(ctx)
    if not w:
        return None
    return 1e3 * harness.device_time_within(ctx.trace.ops, w) / len(w)


def kernels(ctx):
    """The kernels launched in the windows, per call."""
    w = windows(ctx)
    if not w:
        return None
    n = sum(1 for _, t0, _, cat in ctx.trace.ops
            if cat == "kernel" and any(a <= t0 < b for a, b in w))
    return n / len(w)


def host_ms(ctx):
    """The lower median over the captured cosp_simulator calls inside
    `satsim` spans before the stretch of the host ms of every phase of a
    call, summed."""
    d = [r.stamps[-1] - r.stamps[0] for r in entry_trace.calls_in_spans(
        ctx, "cosp_simulator", "satsim")]
    return 1e3 * statistics.median_low(d) if d else None


def plane_gib(ctx):
    """The GiB of the radar's DSD planes that one COSP call materialises
    at the cell's points (the columns of the profiled refreshes), by the
    port's radar counter."""
    from geosradiation_gridcomp_tpu_torch.satsim import radar
    counts = getattr(radar, "counts", None)
    if counts is None or not ctx.shapes:
        return None
    points = ctx.shapes[0]["ncol"]
    planes = [c["plane_bytes"] for c in counts().values()
              if c["points"] == points]
    return max(planes) / 2.0 ** 30 if planes else None
