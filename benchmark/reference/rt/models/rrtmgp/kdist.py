"""k-distribution gas optics facade (ty_gas_optics_rrtmgp equivalent).

Port of geosradiation_gridcomp_tpu/models/rrtmgp/kdist.py. The default
backend is the RRTMG-reduced k-distribution (14 band/112 gpt SW, 16
band/140 gpt LW) driven through the generic calls the GC makes:
get_ngpt/get_nband/band limits, set_solar_variability(Mg, SB),
gas_optics(...). KDistSW and KDistLW take their tables from an RRTMGSW /
RRTMGLW module; their gas optics are setcoef then taumol, through kernel
K5 (SW) and K3 (LW) for CUDA tensors and the plain twins for CPU tensors
or when `plain`. load_kdist_npz, KDistLWNative and KDistSWNative carry an
ingested RRTMGP coefficient set (the npz schema of the reference's
tools/rrtmgp_ingest.py, documented in gas_optics.py) onto the device for
the native interpolation engine.
"""

import os

import numpy as np
import torch

from ..rrtmg.nrlssi2 import solar_source_weights
from ..rrtmg.setcoef_lw import setcoef_lw
from ..rrtmg.setcoef_sw import setcoef_sw
from ..rrtmg.tables_lw import NG_LW
from ..rrtmg.tables_sw import NG_SW
from ..rrtmg.taumol_lw import taumol_lw
from ..rrtmg.taumol_sw import sfluxzen_only, taumol_sw
from .gas_concs import GasConcs

# band limits [cm^-1]
_SW_WAVENUM1 = np.array([2600., 3250., 4000., 4650., 5150., 6150., 7700.,
                         8050., 12850., 16000., 22650., 29000., 38000.,
                         820.])
_SW_WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                         12850., 16000., 22650., 29000., 38000., 50000.,
                         2600.])
_LW_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                         1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                         2600.])
_LW_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080.,
                         1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                         2600., 3250.])

# the coefficient tables the engine reads as float32 tensors on the
# device; the rest of the schema is metadata and stays numpy
TABLE_KEYS = ("kmajor", "planck_frac", "totplnk", "rayl", "solar_src")


def _band_lims_gpt(ng_per_band):
    ends = np.cumsum(ng_per_band)
    starts = ends - np.asarray(ng_per_band) + 1
    return np.stack([starts, ends], axis=-1)      # 1-based inclusive


class KDistSW:
    """SW gas optics with an external (solar) source, on the tables of an
    RRTMGSW module `sw`."""

    def __init__(self, sw, plain=False):
        self.sw = sw
        self.plain = plain
        self._svw = None        # solar variability weights

    # --- metadata surface used by the driver layer -----------------
    def source_is_external(self):
        return True

    def get_ngpt(self):
        return int(np.sum(NG_SW))

    def get_nband(self):
        return len(NG_SW)

    def get_band_lims_wavenumber(self):
        return np.stack([_SW_WAVENUM1, _SW_WAVENUM2], axis=-1)

    def get_band_lims_gpoint(self):
        return _band_lims_gpt(NG_SW)

    def get_press_min(self):
        return 1.0              # Pa; backend tables top out near 0.01 hPa

    def get_temp_min(self):
        return 160.0

    def set_solar_variability(self, mg, sb):
        """NRLSSI2 facular/sunspot adjustment (k_dist%set_solar_variability,
        GEOS_SolarGridComp.F90:4629): isolvar=2 semantics with the indices
        taken from the solar-cycle file, whatever the config's isolvar."""
        self._svw = solar_source_weights(
            2, 0.0, indsolvar=(float(mg), float(sb)))
        return self

    # --- compute ----------------------------------------------------
    def gas_optics(self, play_hpa, tlay, plev_hpa, gas_concs: GasConcs):
        """Gas optical depths, Rayleigh optical depths, and the solar
        source per g-point.

        play/tlay: [ncol, nlay] (TOA-first, hPa/K); plev: [ncol, nlay+1].
        Returns (taug, taur, toa_src) with taug/taur [ncol, nlay, ngpt]
        and toa_src [ncol, ngpt] (unnormalized; scale by tsi/mu0 in rte).
        """
        g = gas_concs
        coefs = setcoef_sw(play_hpa, tlay, plev_hpa,
                           g.get_vmr("h2o", like=tlay),
                           g.get_vmr("o3", like=tlay),
                           g.get_vmr("co2", like=tlay),
                           g.get_vmr("ch4", like=tlay),
                           g.get_vmr("o2", like=tlay),
                           self.sw.reference_tables)
        taumol = taumol_sw
        taug, taur = taumol(coefs, self.sw.taumol_tables)
        sflux = sfluxzen_only(coefs, self.sw.solar_sources(self._svw))
        return taug, taur, sflux


class KDistLW:
    """LW gas optics with an internal (Planck) source, on the tables of an
    RRTMGLW module `lw`."""

    def __init__(self, lw, plain=False):
        self.lw = lw
        self.plain = plain

    def source_is_external(self):
        return False

    def get_ngpt(self):
        return int(np.sum(NG_LW))

    def get_nband(self):
        return len(NG_LW)

    def get_band_lims_wavenumber(self):
        return np.stack([_LW_WAVENUM1, _LW_WAVENUM2], axis=-1)

    def get_band_lims_gpoint(self):
        return _band_lims_gpt(NG_LW)

    def get_press_min(self):
        return 1.0

    def get_temp_min(self):
        return 160.0

    def gas_optics(self, play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
                   gas_concs: GasConcs, dudts=False):
        """Gas optical depths and Planck sources per g-point.

        Returns (taug, sources) where sources is a dict with pfracs,
        planklay, planklev, plankbnd, dplankbnd_dts, pwvcm - the inputs
        of rte.rte_lw.
        """
        g = gas_concs
        coefs = setcoef_lw(
            play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
            *(g.get_vmr(k, like=tlay) for k in (
                "h2o", "o3", "co2", "ch4", "n2o", "o2", "co", "cfc11",
                "cfc12", "hcfc22", "ccl4")),
            self.lw.planck_tables, dudts=dudts)
        taumol = taumol_lw
        taug, pfracs = taumol(coefs, self.lw.taumol_tables)
        sources = dict(pfracs=pfracs, planklay=coefs.planklay,
                       planklev=coefs.planklev, plankbnd=coefs.plankbnd,
                       dplankbnd_dts=coefs.dplankbnd_dts,
                       pwvcm=coefs.pwvcm)
        return taug, sources


