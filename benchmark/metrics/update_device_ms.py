"""update_device_ms (ms): device time per captured radiation_update in
the profiled stretch, every operation that starts between the call and
the end of its synchronise."""

import harness


def read(ctx):
    windows = ctx.update_windows
    if not windows:
        return None
    return 1e3 * harness.device_time_within(ctx.trace.ops, windows) \
        / len(windows)
