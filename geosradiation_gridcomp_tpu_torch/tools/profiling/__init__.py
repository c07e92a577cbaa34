"""Profiling tools of the port: CUDA-event timing (timing.py) and the
Hopper counterparts of the reference's TPU micro-benchmarks."""
