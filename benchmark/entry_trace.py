"""What the per-layer metrics of the captured entry read from the port's
own record of its calls (driver/compiled.py): the CallRecords of the
calls that lie inside the benchmark's spans before the profiled stretch,
the counters of the keys they replayed, and the device's idle time under
the port's "<entry>/<phase>" profiler ranges. Only spans before the
stretch count: after a profiler has run, graph.replay() stays several
times slower on the host for the rest of the process, so the spans after
the stretch read the profiler's residue. A port that keeps no such
record gives None, and so does a cell with no such call.
"""

import bisect
import statistics

import harness

COPIES = ("copies", "fills", "clones")


def _compiled():
    from geosradiation_gridcomp_tpu_torch.driver import compiled
    return compiled


def calls_in_spans(ctx, entry, span):
    """The CallRecords of `entry` that start and end inside one of the
    benchmark's spans named `span` that end before the first profiled
    span (every unprofiled one if none was profiled)."""
    recent = getattr(_compiled(), "recent_calls", None)
    if recent is None:
        return []
    first = min((t0 for _, t0, _, profiled in ctx.spans.spans if profiled),
                default=float("inf"))
    spans = sorted((t0, t1) for n, t0, t1, profiled in ctx.spans.spans
                   if n == span and not profiled and t1 <= first)
    starts = [t0 for t0, _ in spans]
    out = []
    for r in recent():
        if r.entry != entry:
            continue
        k = bisect.bisect_right(starts, r.stamps[0]) - 1
        if k >= 0 and r.stamps[-1] <= spans[k][1]:
            out.append(r)
    return out


def phase_ms(ctx, entry, span, phase):
    """The lower median of the host ms of `phase` over those calls: the
    window's first calls may pay once for the caching allocator's growth
    in clone_out (a new segment while the benchmark holds an answer),
    which a mean of a few calls would carry."""
    d = [r.durations()[phase] for r in calls_in_spans(ctx, entry, span)
         if phase in r.phases]
    return 1e3 * statistics.median_low(d) if d else None


def copies_per_call(ctx, entry, span):
    """The mean over those calls of the copies in, scalar fills and
    clones out that a call of its key makes, by the port's counters."""
    counts = getattr(_compiled(), "counts", None)
    if counts is None:
        return None
    keys = counts().get(entry, {}).get("keys", {})
    n = [sum(keys[r.key][c] for c in COPIES)
         for r in calls_in_spans(ctx, entry, span) if r.key in keys]
    return sum(n) / len(n) if n else None


def capture_s():
    """The host seconds of every capture of the process (static buffers,
    warm-up and capture), by the port's counters."""
    counts = getattr(_compiled(), "counts", None)
    if counts is None:
        return None
    return sum(c["capture_s"] for c in counts().values()) or None


def idle_ms(ctx, windows, entry):
    """The mean device idle ms per window (a call's start to the end of
    its synchronise) in the gaps whose innermost open range at their
    middle, as harness.breakdown names a gap, is one of `entry`'s phase
    ranges."""
    prefix = entry + "/"
    ranges = [r for r in ctx.trace.ranges
              if any(r[1] < b and a < r[2] for a, b in windows)]
    if not windows or not any(r[0].startswith(prefix) for r in ranges):
        return None

    def owned(g0, g1):
        mid = 0.5 * (g0 + g1)
        open_ = [r for r in ranges if r[1] <= mid < r[2]]
        inner = min(open_, key=lambda r: r[2] - r[1])[0] if open_ else ""
        return g1 - g0 if inner.startswith(prefix) else 0.0

    busy = harness.busy_intervals(ctx.trace.ops)
    ends = [e for _, e in busy]
    total = 0.0
    for a, b in windows:
        edge = a
        for s, e in busy[bisect.bisect_right(ends, a):]:
            if s >= b:
                break
            if s > edge:
                total += owned(edge, s)
            edge = max(edge, e)
        if b > edge:
            total += owned(edge, b)
    return 1e3 * total / len(windows)
