"""rats_idle_ms (ms): device idle time per RATS refresh in the profiled
stretch, within each `rats` window (the call to the end of its
synchronise); the breakdown's idle gaps name it by the innermost range
open, the port's "rats_refresh/<gas>", "rats_refresh/stack" and
"rrtmg_lw/<phase>"."""

import rats_trace


def read(ctx):
    windows = rats_trace.windows(ctx)
    if not windows:
        return None
    return 1e3 * sum(rats_trace.idle_within(ctx.trace.ops, windows)) \
        / len(windows)
