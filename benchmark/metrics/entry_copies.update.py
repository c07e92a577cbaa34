"""entry_copies.update (ops): the tensors copied in, scalars filled and
tensors cloned out by one call of the captured radiation_update, by the
port's counters (driver/compiled.py:counts) of the key each call
replayed inside the benchmark's `update` spans that end before the
profiled stretch, mean over those calls."""

import entry_trace


def read(ctx):
    return entry_trace.copies_per_call(ctx, "radiation_update", "update")
