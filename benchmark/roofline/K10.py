"""K10: RRTMGP's SW solver rte_sw (delta scaling, PIFM layer R/T, adding
sweeps, sums over g) for the all-sky and the clear stream of every
column: K10 and its twin compute both streams in all columns, lit or not.

Bytes: read the gas and Rayleigh optical depths and the cloud optical
depth, single-scattering albedo and asymmetry [ncol, nlay, ngpt], the TOA
source [ncol, ngpt], the cosine of the zenith angle [ncol] and the two
band albedos [ncol, nband] (float32) once; write the six level profiles
[ncol, nlay+1] (flux up, down and direct, all-sky and clear) once. The
benchmark's refreshes pass no aerosol, so none is counted.

Work: per (column, layer, g-point) and stream, K6's per-solve count
(roofline/K6.py): in the PIFM two-stream layer two exponentials, one
square root and two divisions (five special-function instructions) and
twenty FP32 instructions; in the adding pass per level two divisions
(two) and ten FP32 instructions. The delta scaling is left out.
"""


def count(s):
    ncol, nlay, g, nb = s["ncol"], s["nlay"], s["ngpt_sw"], s["nband_sw"]
    solves = 2 * ncol * nlay * g
    read = 4 * (5 * ncol * nlay * g + ncol * g + ncol + 2 * nb * ncol)
    written = 4 * 6 * ncol * (nlay + 1)
    return dict(bytes=read + written, sfu=7 * solves, fp32=30 * solves)
