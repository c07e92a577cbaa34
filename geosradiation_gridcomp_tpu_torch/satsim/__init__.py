"""Satellite-simulator subsystem (the reference's GEOSsatsim_GridComp /
COSP v1.x stack), the port of geosradiation_gridcomp_tpu/satsim: every
simulator is a plain PyTorch function over (points, subcolumns, levels)
batches on the device of its inputs; level sweeps are Python loops over
levels or cumulative ops, and the subcolumn sampler draws the reference's
counter-based threefry stream bit for bit (ops/threefry.py). The JAX
package leaves these to XLA: they hold no kernel. `cosp_simulator`, the
reference's jitted driver, is a captured entry (driver/compiled.py): one
CUDA graph per SatsimConfig and input shapes on a card, its body
`cosp.cosp_simulator_eager`; the simulators it calls trace into it, as
the reference's inner jits do."""

from .scops import scops, prec_scops                        # noqa: F401
from .icarus import isccp_simulator                         # noqa: F401
from .misr import misr_simulator                            # noqa: F401
from .modis import modis_l2_simulator, modis_l3_simulator   # noqa: F401
from .lidar import lidar_simulator, lidar_stats, parasol    # noqa: F401
from .radar import (quickbeam_simulator, radar_cfad,        # noqa: F401
                    lidar_only_freq_cloud)
from .cosp import cosp_simulator, SatsimInputs, SatsimConfig  # noqa: F401
