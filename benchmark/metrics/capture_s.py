"""capture_s (s): host seconds the process spent capturing its graphs,
every key of every captured entry (static buffers, warm-up and capture),
by the port's counters (driver/compiled.py:counts); part of setup_s."""

import entry_trace


def read(ctx):
    return entry_trace.capture_s()
