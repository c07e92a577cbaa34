"""The plain reference of the COSP satellite simulators: a frozen copy of
the port's satsim/ (GEOSsatsim_GridComp's COSP v1.x: SCOPS, ISCCP, MISR,
MODIS, CALIPSO and CloudSat), copied from the port at commit ce477a6.

Only the plain bodies are here: `cosp.cosp_simulator_eager` and the
simulators it calls, with the radar's points in blocks of PLANE_BYTES as
the port's, so that it fits on the card beside the port's graphs. The
port's captured entry, its profiler ranges and its radar counter are
left out. Its tables are read by path (rt/tables.py); nothing here
imports jax, the JAX package or the port.
"""
