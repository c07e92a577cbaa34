"""device_idle_pct.refresh (%): the share of the profiled stretch of
back-to-back refreshes in which no kernel, copy or fill ran on the
device."""

import harness


def read(ctx):
    return harness.idle_pct(ctx)
