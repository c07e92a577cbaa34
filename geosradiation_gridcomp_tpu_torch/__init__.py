"""PyTorch + CUDA port of the GEOS radiation framework, for NVIDIA Hopper.

Mirrors the JAX reference package `geosradiation_gridcomp_tpu` module by
module (`driver/`, `models/rrtmg/`, `ops/`): each port module keeps the
reference's function names and its [ncol, nlay, ngpt] TOA-first layouts.
Every Pallas kernel of the reference becomes a CUDA C++ kernel under
`csrc/`, built with nvcc for sm_90a by `kernels/build.py` and loaded with
ctypes; each has a plain-PyTorch twin, which the wrapper runs for CPU
tensors and inside `kernels.twins.twins()`.

The port stands alone: it imports neither jax nor anything of the
reference package. It keeps its own copies of the reference's numpy-only
modules (`config`, `constants`, `tables`, `models/rrtmg/tables_lw`,
`tables_sw`, `nrlssi2`) under the same names, and reads the coefficient
tables (npz data) from the reference's `data/` directory by path.

The constructors (`scene.example_inputs`, `RRTMGLW/RRTMGSW.
from_reference_tables` and the table loaders) put their tensors on the
card unless the caller passes `device="cpu"`; the drivers follow the
device of their inputs.
"""

__version__ = "0.1.0"
