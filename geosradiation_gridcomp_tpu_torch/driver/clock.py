"""Host-side radiation clock: refresh alarm + heartbeat ordering.

The port's own copy of geosradiation_gridcomp_tpu/driver/clock.py, line
for line below this docstring: plain Python, no tensors.

Functional equivalent of the reference's ESMF alarm machinery: SOLAR/IRRAD
create a RunAlarm with interval SOLAR_DT (GEOS_SolarGridComp.F90:451-460)
and, each heartbeat, run the expensive full RT only when the alarm rings;
the cheap export update runs every step, either before or after the
refresh depending on CALLED_LAST (GEOS_SolarGridComp.F90:3076-3087,
GEOS_IrradGridComp.F90:1398-1424). The refresh-vs-update decision is made
on the host, from plain Python floats.
"""

import dataclasses


@dataclasses.dataclass
class RadiationClock:
    """Tracks model time and decides refresh vs update.

    run_dt: heartbeat [s]; solar_dt: refresh interval [s] (must be a
    multiple of run_dt, as MAPL requires of SOLAR_DT vs RUN_DT);
    called_last: if True the refresh happens at the END of the heartbeat
    (exports first, as when radiation is the last child in the parent's
    run sequence).
    """
    run_dt: float
    solar_dt: float
    called_last: bool = False
    time_s: float = 0.0            # seconds since start-of-run epoch
    start_doy: float = 172.0       # day-of-year at epoch
    start_utc_hours: float = 0.0

    def __post_init__(self):
        n = self.solar_dt / self.run_dt
        if abs(n - round(n)) > 1e-9 or n < 1:
            raise ValueError(
                f"solar_dt ({self.solar_dt}) must be a positive multiple "
                f"of run_dt ({self.run_dt})")

    # -- time queries -------------------------------------------------
    @property
    def utc_hours(self):
        h = self.start_utc_hours + self.time_s / 3600.0
        return h % 24.0

    @property
    def doy(self):
        days = (self.start_utc_hours + self.time_s / 3600.0) / 24.0
        return self.start_doy + days - (self.start_utc_hours / 24.0)

    def alarm_ringing(self):
        """True when this heartbeat lands on a refresh boundary."""
        k = self.time_s / self.solar_dt
        return abs(k - round(k)) * self.solar_dt < 1e-6

    def tick(self):
        """Advance one heartbeat. Returns the actions for the *new* step
        as an ordered list of 'refresh' / 'update' strings."""
        self.time_s += self.run_dt
        acts = []
        ring = self.alarm_ringing()
        if self.called_last:
            acts.append("update")
            if ring:
                acts.append("refresh")
        else:
            if ring:
                acts.append("refresh")
            acts.append("update")
        return acts

    # -- checkpoint ---------------------------------------------------
    def state_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d):
        return cls(**d)
