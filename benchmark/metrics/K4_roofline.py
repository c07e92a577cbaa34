"""K4_roofline (%): the share of its roofline that kernel K4, the LW
radiative transfer (models/rrtmg/rtrnmc_cuda.py, csrc/rtrnmc.cu),
reaches in the profiled refreshes: the least time of the stage's work at
their shapes (roofline/K4.py) over the kernel's device time in them.
None where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K4", "rtrnmc_kernel")
