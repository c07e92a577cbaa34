"""The one switch between a kernel and its plain PyTorch twin.

Every kernel (K1-K10, P1-P3) keeps a plain twin that computes the same
values: it runs for CPU tensors, and on a card it is the reference the
kernel is held to. Each kernel function asks `use_kernel` of one of its
tensors and runs its twin when the answer is no; nothing else in the
package chooses. `twins()` puts every kernel function called inside it,
on this thread, on its twin, and makes a captured entry called inside it
run its body (driver/compiled.py), so a plain body never records a graph.
"""

import contextlib
import threading


class _Depth(threading.local):
    depth = 0               # twins() blocks entered on this thread


_TWINS = _Depth()


def active():
    """Whether the calling thread is inside twins()."""
    return _TWINS.depth > 0


@contextlib.contextmanager
def twins(on=True):
    """Within the block every kernel function runs its plain twin. Blocks
    nest like driver.compiled.disable_capture; twins(False) changes
    nothing, so a nested call can never turn off an outer block."""
    add = 1 if on else 0
    _TWINS.depth += add
    try:
        yield
    finally:
        _TWINS.depth -= add


def use_kernel(t):
    """Whether a kernel function launches its kernel for tensor t: on a
    CUDA device and outside twins()."""
    return t.device.type == "cuda" and not active()
