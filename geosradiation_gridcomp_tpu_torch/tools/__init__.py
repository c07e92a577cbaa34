"""Entry points of the port beyond the step: the verification suite
(verify.py) and the profiling tools (profiling/)."""
