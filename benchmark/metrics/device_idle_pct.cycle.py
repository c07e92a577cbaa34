"""device_idle_pct.cycle (%): the share of the profiled stretch of whole
radiation intervals (a refresh and its heartbeats' updates) in which no
kernel, copy or fill ran on the device."""

import harness


def read(ctx):
    return harness.idle_pct(ctx)
