"""Radiation configuration (the reference's MAPL resource surface).

The port's own copy of geosradiation_gridcomp_tpu/config.py, field for
field and default for default, so that the port loads nothing of the JAX
package.

Static fields feed jit specialization, mirroring AGCM.rc resources
(SURVEY.md par. "Config / flag system"): scheme flags USE_RRTMG_SORAD /
USE_RRTMG_IRRAD (GEOS_SolarGridComp.F90:7806-7855), super-layer pressures
PRS_LOW_MID_CLOUDS / PRS_MID_HIGH_CLOUDS, condensate inhomogeneity mode,
solar constant handling, and time control (heartbeat / refresh interval).
"""

import dataclasses
import enum


class Scheme(enum.Enum):
    CHOU = "chou"
    RRTMG = "rrtmg"
    RRTMGP = "rrtmgp"


def choose_scheme(use_rrtmgp=False, use_rrtmg=False):
    """Resource-flag scheme selection with the reference's precedence
    RRTMGP > RRTMG > Chou (choose_solar_scheme / choose_irrad_scheme,
    GEOS_SolarGridComp.F90:7806-7855)."""
    if use_rrtmgp:
        return Scheme.RRTMGP
    if use_rrtmg:
        return Scheme.RRTMG
    return Scheme.CHOU


@dataclasses.dataclass(frozen=True)
class RadiationConfig:
    # scheme selection (precedence RRTMGP > RRTMG > Chou,
    # GEOS_SolarGridComp.F90:7806-7855; see choose_scheme)
    sw_scheme: Scheme = Scheme.RRTMG
    lw_scheme: Scheme = Scheme.RRTMG

    # time control [s]
    run_dt: float = 1800.0            # model heartbeat (RUN_DT)
    solar_dt: float = 3600.0          # full-RT refresh interval (SOLAR_DT)

    # cloud super-layer boundaries [Pa]
    prs_mid_high_clouds: float = 40000.0    # PRS_MID_HIGH_CLOUDS
    prs_low_mid_clouds: float = 70000.0     # PRS_LOW_MID_CLOUDS

    # physics options
    solar_constant: float = 1361.0          # SOLAR_CONSTANT (W/m^2)
    # NRLSSI2 solar variability (ISOLVAR / SOLCYCFRAC / INDSOLVAR_*,
    # GEOS_SolarGridComp.F90:6244,6308-6309): -1 Kurucz const sun,
    # 0 NRLSSI2 mean sun, 1 mean cycle at solcycfrac, 2 direct Mg/SB
    # indices, 3 mean sun with band scaling
    isolvar: int = -1
    solcycfrac: float = 0.0                 # position in mean cycle [0,1]
    indsolvar: tuple = None                 # (Mg, SB) or amplitude scales
    co2: float = 410.0e-6                   # volume mixing ratio default
    condensate_inhomogeneity: int = 1       # 0 homog, 1 beta, 2 gamma
    iceflag_lw: int = 3
    liqflag_lw: int = 1
    iceflag_sw: int = 3
    liqflag_sw: int = 1
    trace_gases: bool = True                # Chou LW `trace`
    ts_derivs: bool = True                  # LW dF/dTs Jacobians

    # RRTMGP coefficient files (the reference's SOLAR_DATA/IRRAD_DATA
    # resources naming rrtmgp-gas-sw-*.nc / rrtmgp-gas-lw-*.nc,
    # GEOS_SolarGridComp.F90:4609-4621, GEOS_IrradGridComp.F90:2151+):
    # paths to npz sets produced by tools/rrtmgp_ingest.py. When set and
    # the scheme is RRTMGP, fluxes run through the NATIVE interpolation
    # engine (models/rrtmgp/gas_optics.py); when None, the RRTMG-reduced
    # facade backs the RRTMGP API.
    rrtmgp_kdist_sw: str = None
    rrtmgp_kdist_lw: str = None

    # Lazy diagnostics (the reference's associated-pointer idiom: exports
    # are computed only when a consumer requests them,
    # GEOS_RadiationGridComp.F90:743-785). This static set feeds jit
    # specialization: any token removed here is pruned from the compiled
    # program. Fluxes/heating rates are always produced.
    #   olrb      band OLR internals + Ts-advanced export
    #   tbrb      band brightness temperatures (implies olrb)
    #   band_sfc  band-resolved surface direct/diffuse SW fluxes
    #   clear_counts  McICA clear-subcolumn cloud-fraction diagnostics
    outputs: frozenset = frozenset(
        {"olrb", "tbrb", "band_sfc", "clear_counts"})

    def wants(self, name):
        if name == "olrb":
            return "olrb" in self.outputs or "tbrb" in self.outputs
        return name in self.outputs

    def effective_scon(self):
        """TOA solar constant used for flux normalization. solar_constant=0
        selects the scheme-internal value (1368.22 Kurucz for isolvar=-1,
        1360.85 NRLSSI2 mean otherwise), matching rrtmg_sw_rad.F90:975-979."""
        if self.solar_constant > 0.0:
            return self.solar_constant
        return 1368.22 if self.isolvar == -1 else 1360.85

    def superlayer_indices(self, pref_pa):
        """Level indices (1-based, TOA-first) nearest the super-layer
        boundary pressures, from a 1-D reference mid-level pressure [Pa]
        (the reference derives LCLDMH/LCLDLM from PREF,
        GEOS_SolarGridComp.F90:3035-3066)."""
        import numpy as np
        p = np.asarray(pref_pa)
        ict = int(np.argmin(np.abs(p - self.prs_mid_high_clouds))) + 1
        icb = int(np.argmin(np.abs(p - self.prs_low_mid_clouds))) + 1
        return ict, icb
