"""k-distribution gas optics facade (ty_gas_optics_rrtmgp equivalent).

Port of geosradiation_gridcomp_tpu/models/rrtmgp/kdist.py. The default
backend is the RRTMG-reduced k-distribution (14 band/112 gpt SW, 16
band/140 gpt LW) driven through the generic calls the GC makes:
get_ngpt/get_nband/band limits, set_solar_variability(Mg, SB),
gas_optics(...). KDistSW and KDistLW take their tables from an RRTMGSW /
RRTMGLW module; their gas optics are setcoef then taumol, through kernel
K5 (SW) and K3 (LW), and the LW Planck rows through K9, for CUDA tensors
and the plain twins otherwise (kernels.twins). load_kdist_npz,
KDistLWNative and KDistSWNative carry an
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
from ..rrtmg.taumol_lw_cuda import taumol_lw_fast
from ..rrtmg.taumol_sw import sfluxzen_only
from ..rrtmg.taumol_sw_cuda import taumol_sw_fast
from .gas_concs import GasConcs
from .gas_optics import gas_optics_lw, gas_optics_sw

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

    def __init__(self, sw):
        self.sw = sw
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
        taug, taur = taumol_sw_fast(coefs, self.sw.taumol_tables)
        sflux = sfluxzen_only(coefs, self.sw.solar_sources(self._svw))
        return taug, taur, sflux


class KDistLW:
    """LW gas optics with an internal (Planck) source, on the tables of an
    RRTMGLW module `lw`."""

    def __init__(self, lw):
        self.lw = lw

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
        taug, pfracs = taumol_lw_fast(coefs, self.lw.taumol_tables)
        sources = dict(pfracs=pfracs, planklay=coefs.planklay,
                       planklev=coefs.planklev, plankbnd=coefs.plankbnd,
                       dplankbnd_dts=coefs.dplankbnd_dts,
                       pwvcm=coefs.pwvcm)
        return taug, sources


def load_kdist_npz(path_or_dict, device="cuda"):
    """A native k-distribution in the dict form the engine consumes: from
    an npz of the tools/rrtmgp_ingest.py schema (the minor blocks
    reassembled from their minor_{which}_{field} keys) or from that dict
    form itself, with the coefficient tables (TABLE_KEYS and each minor
    block's kminor) as float32 tensors on device."""
    if isinstance(path_or_dict, (str, bytes, os.PathLike)):
        with np.load(path_or_dict, allow_pickle=False) as f:
            raw = dict(f)
        data = {k: v for k, v in raw.items() if not k.startswith("minor_")}
        for which in ("lower", "upper"):
            pre = f"minor_{which}_"
            keys = [k for k in raw if k.startswith(pre)]
            data[f"minor_{which}"] = (
                {k[len(pre):]: raw[k] for k in keys} if keys else None)
    else:
        data = dict(path_or_dict)
    if "h2o_idx" not in data:
        names = [str(s) for s in data["gas_names"]]
        data["h2o_idx"] = np.int64(names.index("h2o") + 1)

    def table(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    for k in TABLE_KEYS:
        if k in data:
            data[k] = table(data[k])
    for which in ("minor_lower", "minor_upper"):
        if data.get(which) is not None:
            data[which] = dict(data[which], kminor=table(
                data[which]["kminor"]))
    return data


class _KDistNative:
    """Metadata surface of an ingested coefficient set on device."""

    def __init__(self, data, device="cuda"):
        self.data = load_kdist_npz(data, device)

    def get_ngpt(self):
        return int(self.data["kmajor"].shape[-1])

    def get_nband(self):
        return int(self.data["band_lims_gpt"].shape[0])

    def get_band_lims_wavenumber(self):
        return np.asarray(self.data["band_lims_wvn"])

    def get_band_lims_gpoint(self):
        return np.asarray(self.data["band_lims_gpt"])

    def _vmrs(self, gas_concs, like):
        return {nm: gas_concs.get_vmr(nm, like=like)
                for nm in (str(s) for s in self.data["gas_names"])}


class KDistLWNative(_KDistNative):
    """LW gas optics backed by the NATIVE interpolation engine
    (gas_optics.py) driven by an ingested RRTMGP coefficient set:
    arbitrary bands, g-points, gases, flavors, and minor contributors.

    Pair with rte_native.rte_lw_native for arbitrary band structures
    (rte.rte_lw assumes the 16-band RRTMG layout).
    """

    def source_is_external(self):
        return False

    def get_press_min(self):
        return float(np.min(self.data["press_ref"]))

    def get_temp_min(self):
        return float(np.min(self.data["temp_ref"]))

    def gas_optics(self, play_hpa, tlay, plev_hpa, tlev, tsfc, emis,
                   gas_concs: GasConcs, dudts=False):
        del emis, dudts                 # dplankbnd_dts always computed
        return gas_optics_lw(self.data, play_hpa * 100.0, tlay,
                             plev_hpa * 100.0, tlev, tsfc,
                             self._vmrs(gas_concs, tlay))


class KDistSWNative(_KDistNative):
    """SW counterpart of KDistLWNative (external solar source)."""

    def source_is_external(self):
        return True

    def set_solar_variability(self, mg, sb):
        # native files carry quiet/facular/sunspot components; the
        # shipped synthetic sets carry only the quiet sun
        return self

    def gas_optics(self, play_hpa, tlay, plev_hpa, gas_concs: GasConcs):
        return gas_optics_sw(self.data, play_hpa * 100.0, tlay,
                             plev_hpa * 100.0, self._vmrs(gas_concs, tlay))
