"""entry_host_ms.refresh (ms): host time from the call of the captured
radiation_refresh to its return, before the synchronise (copy-in,
replay launch, clone-out), mean over the window outside the profiled
stretch."""

import harness


def read(ctx):
    return harness.mean_span_ms(ctx, "refresh")
