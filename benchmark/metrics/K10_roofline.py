"""K10_roofline (%): the share of its roofline that kernel K10, RRTMGP's
SW solver (models/rrtmgp/rte_sw_cuda.py, csrc/rte_sw.cu), reaches in the
profiled refreshes: the least time of the stage's work at their shapes
(roofline/K10.py) over the kernel's device time in them. None where the
kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K10", "rte_sw_kernel")
