"""rats_device_ms (ms): device time per RATS refresh in the profiled
stretch, every operation that starts between the benchmark's `rats` span
and the end of its synchronise: the 8 replays of the captured rrtmg_lw
graph, the zero fills and the stacking."""

import harness
import rats_trace


def read(ctx):
    windows = rats_trace.windows(ctx)
    if not windows:
        return None
    return 1e3 * harness.device_time_within(ctx.trace.ops, windows) \
        / len(windows)
