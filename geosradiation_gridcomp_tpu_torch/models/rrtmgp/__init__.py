"""RRTMGP-style radiation scheme (the reference's third scheme), PyTorch.

Port of geosradiation_gridcomp_tpu/models/rrtmgp/: the reference treats
RRTMGP as an external library; this package provides that surface.

  * GasConcs             - mo_gas_concentrations equivalent
  * KDistSW / KDistLW    - ty_gas_optics_rrtmgp facade over the
                           RRTMG-reduced k-distribution (g112 SW / g140
                           LW): setcoef + taumol, kernels K5 / K3;
                           KDistSWNative / KDistLWNative over an ingested
                           coefficient set (the native engine,
                           gas_optics.py)
  * rng                  - mo_rng equivalents (threefry/MT19937)
  * sampling             - mo_cloud_sampling equivalents
  * rte                  - generic rte_sw (two-stream + adding) and rte_lw
                           (no-scattering transport, kernel K4) solvers;
                           rte_native their band-agnostic counterparts
  * scheme               - rrtmgp_sw / rrtmgp_lw, the GC's RRTMGP paths
"""

from .gas_concs import GasConcs                              # noqa: F401
from .kdist import KDistSW, KDistLW                          # noqa: F401
from .sampling import (sampled_mask_max_ran,                 # noqa: F401
                       sampled_urand_gen_max_ran, draw_samples)
from .rte import rte_sw, rte_lw                              # noqa: F401
from .scheme import rrtmgp_sw, rrtmgp_lw                     # noqa: F401
