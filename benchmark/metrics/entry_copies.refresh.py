"""entry_copies.refresh (ops): the tensors copied in, scalars filled and
tensors cloned out by one call of the captured radiation_refresh, by the
port's counters (driver/compiled.py:counts) of the key each call
replayed inside the benchmark's `refresh` spans that end before the
profiled stretch, mean over those calls."""

import entry_trace


def read(ctx):
    return entry_trace.copies_per_call(ctx, "radiation_refresh", "refresh")
