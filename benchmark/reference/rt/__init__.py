"""The plain reference of the benchmark: a frozen copy of the port's
plain PyTorch path for the RRTMG SW+LW refresh, the RRTMGP facade
refresh and the per-heartbeat update, copied from the port at commit
c3f7f48 and cut down to those paths.

Every kernel of the port is its plain twin here (the `*_cuda` wrappers
and the kernel library are gone), and every captured entry is its eager
body: the module docstrings still name the kernels (K1-K7) and the
captured entries of the port they were copied from, to say what each
piece stands in for. Chou-Suarez, RATS and the native RRTMGP engine are
left out. The coefficient tables are read from the reference package's
npz files by path; nothing here imports jax, the JAX package or the
port, and the port's later changes do not reach it.
"""
