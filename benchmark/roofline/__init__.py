"""The work of each kernel stage of the RRTMG / RRTMGP refresh, counted
from the stage's own inputs and outputs at a refresh's shapes, and the
H100's peaks (peaks.py). One module per stage, named by the port's
kernel id (K1-K6), each with count(shapes) -> a count for
peaks.least_seconds.

The shapes of one refresh (the loops compute them from the scene and the
hour, never from the port): ncol, nlay; ngpt_lw, ngpt_sw; nband_lw,
nband_sw; cloudy_cols (columns with cloud in some layer), cloudy_depth_lw
(the layers from the top through the lowest cloudy one, summed over the
cloudy columns), lit_cols (columns with sunlight in the refresh
interval), lit_cloudy_cols and cloudy_depth_sw (the same over the lit
cloudy columns).

The counts follow the algorithm, not an implementation: each input byte
is read once and each output byte written once, whichever arrays a
kernel of today happens to receive, and work that the inputs do not need
(draws in clear columns, the SW in dark ones) is not counted. The
coefficient tables (a few MB, read once) are left out. Every count is a
floor, so that a share can never pass 100 % by a miscount.
"""
