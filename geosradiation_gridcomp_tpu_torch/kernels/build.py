"""Build and load the port's CUDA kernels (csrc/*.cu) for Hopper.

nvcc compiles every source under csrc/ into one shared library with a
plain C interface, at first use, into build/torch_kernels/ of the
checkout: one nvcc process per source, all started together, then one
link. The file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ctypes: every pointer and the stream are passed as
c_void_p, every int as c_int, and each entry point returns
cudaGetLastError() after its launch.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

import collections
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# No --use_fast_math: tfn and the eta weights need accurate expf and powf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Kernel launches per wrapper name. A wrapper adds one where it launches
# its kernel and nowhere else.
LAUNCHES = collections.Counter()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path():
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base and os.path.exists(os.path.join(base, "bin", "nvcc")):
            return os.path.join(base, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _run_all(cmds, logs):
    """Run the commands side by side, each writing its output to its log
    file (so that no pipe fills); raise with the log of the first that
    fails."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    for cmd, p, log in zip(cmds, procs, logs):
        if p.wait() != 0:
            for q in procs:
                q.wait()
            with open(log) as f:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{cmd[-1]}:\n{f.read()}")


def build():
    """Compile csrc/*.cu into one shared library, unless a library of the
    same sources and flags is there already; return its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libgeosrad_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = nvcc_path()
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
              for o, s in zip(objs, cus)], [f"{o}.log" for o in objs])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]],
             [f"{tmp}.log"])
    for f in [*objs, *(f"{o}.log" for o in objs), f"{tmp}.log"]:
        os.remove(f)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first call)."""
    return ctypes.CDLL(build())


@functools.lru_cache(maxsize=None)
def entry(lib, name, nptr, nint, nfloat=0):
    """C entry point `name` of lib taking nptr pointers, nint ints, nfloat
    floats and the stream, returning a cudaError_t as int (set up once per
    library and name: the wrappers call this on every launch)."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                   + [ctypes.c_float] * nfloat + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t):
    """PyTorch's current stream on t's device, as a pointer (None on the
    CPU, where tests/test_torch_kernels_emulated.py runs the kernels)."""
    if t.device.type != "cuda":
        return None
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name, *tensors):
    """Raise unless every tensor lies on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must all be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
