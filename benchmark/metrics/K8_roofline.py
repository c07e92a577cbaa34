"""K8_roofline (%): the share of its roofline that kernel K8, RRTMGP's
McICA draws (ops/mcica_gmr_cuda.py, csrc/mcica_gmr.cu), reaches in the
profiled refreshes, over its SW and LW launches: the least time of the
stage's work at their shapes (roofline/K8.py) over the kernel's device
time in them. None where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K8", "mcica_gmr_kernel")
