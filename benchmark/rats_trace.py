"""What the RATS cell's per-layer metrics read: the benchmark's `rats`
windows in the profiled stretch, the port's record of the captured
rrtmg_lw calls inside its `rats` spans before the stretch
(driver/compiled.py, through entry_trace), and the port's RATS counters
(driver/diagnostics.py:counts). A port without such a record or counter
gives None, and so does a cell with no RATS call.
"""

import bisect
import statistics

import entry_trace
import harness


def windows(ctx):
    """(start, end) of each RATS refresh in the stretch: its `rats` span's
    start to the end of the sync that follows it."""
    return harness.unit_windows(ctx.trace, "rats")


def idle_within(ops, windows):
    """Seconds of each window in which no device operation ran."""
    busy = harness.busy_intervals(ops)
    return [(b - a) - sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
            for a, b in windows]


def lw_calls_by_span(ctx):
    """The captured rrtmg_lw calls of each `rats` span before the
    stretch, one list per span; only the spans with the most calls, so
    that a span whose first calls left the port's ring does not count."""
    records = entry_trace.calls_in_spans(ctx, "rrtmg_lw", "rats")
    starts = sorted(t0 for n, t0, _, profiled in ctx.spans.spans
                    if n == "rats" and not profiled)
    groups = {}
    for r in records:
        k = bisect.bisect_right(starts, r.stamps[0]) - 1
        groups.setdefault(k, []).append(r)
    most = max(map(len, groups.values()), default=0)
    return [g for _, g in sorted(groups.items()) if len(g) == most]


def host_ms(ctx):
    """The lower median over `rats` spans of the host ms that the span's
    captured rrtmg_lw calls spent in their phases, summed."""
    spans = [sum(r.stamps[-1] - r.stamps[0] for r in g)
             for g in lw_calls_by_span(ctx)]
    return 1e3 * statistics.median_low(spans) if spans else None


def copies(ctx):
    """Per RATS refresh, by the port's counters: the copies in, fills
    and clones out of one captured rrtmg_lw call inside the `rats` spans
    (entry_trace.copies_per_call) times the solves a refresh makes, plus
    the fills and copies that rats_refresh makes a call and that
    rats_update makes over the heartbeats of one refresh."""
    from geosradiation_gridcomp_tpu_torch.driver import diagnostics
    rats_counts = getattr(diagnostics, "counts", None)
    per_solve = entry_trace.copies_per_call(ctx, "rrtmg_lw", "rats")
    if rats_counts is None or per_solve is None:
        return None
    own = rats_counts()
    refresh, update = own["rats_refresh"], own["rats_update"]
    if not refresh["calls"]:
        return None
    per_update = (update["fills"] + update["copies"]) / update["calls"] \
        if update["calls"] else 0.0
    return (per_solve * refresh["solves"] + refresh["fills"]
            + refresh["copies"] + per_update * update["calls"]) \
        / refresh["calls"]
