"""Solar-cycle forcing file: runtime reader for NRLSSI2 daily data.

The port's own copy of geosradiation_gridcomp_tpu/driver/solar_cycle.py,
line for line below this docstring: numpy only.

The reference reads a text file (SOLAR_CYCLE_FILE_NAME resource,
GEOS_SolarGridComp.F90:2958) of daily rows `yyyy doy TSI Mg SB` produced
by the offline NRLSSI2 preprocessor
(GEOS_RadiationShared/NRLSSI2/TSI_Mg_SB_merged_from_daily.py:130-137) and
feeds the RRTMG SW scheme with the current solar constant and the Mg
(facular) / SB (sunspot) indices for isolvar=2. The lookup happens once
per refresh on the host; its values reach the refresh as the config's
solar_constant and indsolvar.
"""

import dataclasses
import datetime as _dt

import numpy as np


@dataclasses.dataclass(frozen=True)
class SolarCycleData:
    """Daily NRLSSI2 series; values valid at 12:00 GMT (file header)."""
    days: np.ndarray   # [n] int, proleptic-Gregorian ordinal of each day
    tsi: np.ndarray    # [n] W/m^2 at 1 AU
    mg: np.ndarray     # [n] facular Mg "Bremen" index
    sb: np.ndarray     # [n] sunspot SB "SPOT67" index

    def at(self, when: _dt.datetime):
        """Time-interpolated (TSI, Mg, SB) at `when` (UTC).

        Daily averages are treated as valid at local noon GMT, linearly
        interpolated between bracketing noons (the reference's `gettime`,
        TSI_Mg_SB_merged_from_daily.py:64-93). Outside the data range the
        nearest endpoint persists (the reference's persistence forecast).
        """
        noon = when.replace(hour=12, minute=0, second=0, microsecond=0)
        d0 = noon.toordinal()
        # fraction contributed by the other bracketing noon
        f = abs((when - noon).total_seconds()) / 86400.0
        d1 = d0 + (-1 if when < noon else 1)

        def day_vals(ordinal):
            i = np.searchsorted(self.days, ordinal)
            i = int(np.clip(i, 0, len(self.days) - 1))
            if self.days[i] != ordinal:     # gap or out of range: persist
                i = int(np.clip(
                    np.searchsorted(self.days, ordinal, side="right") - 1,
                    0, len(self.days) - 1))
            return self.tsi[i], self.mg[i], self.sb[i]

        v0 = np.array(day_vals(d0))
        v1 = np.array(day_vals(d1))
        tsi, mg, sb = (1.0 - f) * v0 + f * v1
        return float(tsi), float(mg), float(sb)

    def at_doy(self, year: int, doy: float):
        """Convenience: values at fractional day-of-year (1-based)."""
        base = _dt.datetime(year, 1, 1)
        return self.at(base + _dt.timedelta(days=float(doy) - 1.0))


def read_solar_cycle_file(path: str) -> SolarCycleData:
    """Parse the NRLSSI2.vYYYY.txt format: comment lines start with '#',
    data rows are `yyyy doy TSI Mg SB`."""
    years, doys, tsi, mg, sb = [], [], [], [], []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            years.append(int(parts[0]))
            doys.append(int(parts[1]))
            tsi.append(float(parts[2]))
            mg.append(float(parts[3]))
            sb.append(float(parts[4]))
    days = np.array([
        _dt.date(y, 1, 1).toordinal() + d - 1 for y, d in zip(years, doys)])
    order = np.argsort(days)
    return SolarCycleData(days=days[order],
                          tsi=np.asarray(tsi)[order],
                          mg=np.asarray(mg)[order],
                          sb=np.asarray(sb)[order])
