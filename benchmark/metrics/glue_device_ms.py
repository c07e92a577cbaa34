"""glue_device_ms (ms): device time per refresh of every operation that
is not one of the port's own CUDA kernels (the __global__ functions of
its csrc/): the plain PyTorch of the schemes and drivers (gathers,
elementwise kernels, RRTMGP's McICA draws) and the copies in and out."""

import harness


def read(ctx):
    windows = ctx.refresh_windows
    if not windows:
        return None
    glue = [o for o in ctx.trace.ops if not (
        o[3] == "kernel" and harness.kernel_base(o[0]) in ctx.port_kernels)]
    return 1e3 * harness.device_time_within(glue, windows) / len(windows)
