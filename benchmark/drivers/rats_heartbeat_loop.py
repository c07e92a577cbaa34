"""The model loop's radiation interval with GEOS's RATS diagnostics
(GEOS_IrradGridComp.F90:3405-3468): at each alarm the port's captured
`radiation_refresh`, then `rats_refresh`, which solves the LW again once
for each gas of the configuration's `rats_gases` with that gas zeroed
(each solve replays the captured `rrtmg_lw` graph); at every heartbeat
the captured `radiation_update`, then `rats_update`, which advances the
RATS fluxes with that heartbeat's skin temperature and gives each gas's
forcing. One caller, each call synchronised before the next (the model
reads its outputs).

Traffic, clock, skin temperature and packing are the heartbeat loop's
(drivers/heartbeat_loop.py, whose Loop this one extends). A unit of the
window is one radiation interval: the alarm's refresh and RATS refresh,
then each heartbeat's update and RATS update up to the next alarm. The
benchmark's spans: `clock`, `refresh`, `rats`, `update`, `rats_update`,
and a `sync` after each call.
"""

import os
import time

import harness
import program
from reference.compare import worst
from reference.rats import RatsReference, compare_rats, compare_rats_update

heartbeat_loop = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "heartbeat_loop.py"), "bench_driver_heartbeat_loop")
DAY_S = heartbeat_loop.DAY_S


class Loop(heartbeat_loop.Loop):
    def __init__(self, cell, seed, spans, device="cuda"):
        from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
            rats_refresh, rats_update)
        super().__init__(cell, seed, spans, device)
        t0 = time.perf_counter()
        self.gases = tuple(cell.config["rats_gases"])
        self._rats_refresh, self._rats_update = rats_refresh, rats_update
        # set-up: the first interval's RATS (captures the rrtmg_lw graph)
        self.rats = self.rats_refresh(self._at(0.0)[0])
        self.rats_update(self._beat())
        program.sync(device)
        self.setup_phases["rats_warm_up"] = time.perf_counter() - t0

    def rats_refresh(self, doy):
        return self._rats_refresh(self.inp, doy, self.cfg, self.ict,
                                  self.icb, gases=self.gases)

    def rats_update(self, beat):
        return self._rats_update(self.rats, self.states[1], self.ts[beat])

    def run(self, seconds, stretch):
        """Radiation intervals until `seconds` have passed; the window ends
        with the last one's synchronise."""
        spans, clock, sync = self.spans, self.clock, program.sync
        i = 0
        start = time.perf_counter()
        while True:
            stretch.at_unit(i)
            item = None
            for _ in range(self.per_alarm):
                with spans("clock"):
                    if clock.time_s + clock.run_dt >= DAY_S:
                        clock.time_s -= DAY_S
                    acts = clock.tick()
                    beat = self._beat()
                if "refresh" in acts:
                    alarm = (clock.doy, clock.utc_hours)
                    with spans("refresh"):
                        self.states = self.refresh(*alarm)
                    with spans("sync"):
                        sync(self.device)
                    with spans("rats"):
                        self.rats = self.rats_refresh(alarm[0])
                    with spans("sync"):
                        sync(self.device)
                    item = dict(alarm=alarm, states=self.states,
                                rats=self.rats, updates=[])
                with spans("update"):
                    out = self.update(beat)
                with spans("sync"):
                    sync(self.device)
                with spans("rats_update"):
                    rats_out = self.rats_update(beat)
                with spans("sync"):
                    sync(self.device)
                item["updates"].append((beat, clock.doy, clock.utc_hours,
                                        out, rats_out))
            end = time.perf_counter()
            self.samples.offer(i, item)
            i += 1
            if end - start >= seconds and not stretch.pending:
                break
        stretch.at_unit(i)
        self.window = dict(units=i, seconds=end - start)
        return i

    def release(self):
        super().release()
        del self.rats

    def answers(self, ref):
        """Pairs of the port's and the reference's answers to the sampled
        intervals: the refresh's states, every update's exports, the RATS
        state and every RATS update, the reference's updates run from its
        own states."""
        rats_ref = RatsReference(ref, self.gases)
        bucket = self.cell.workload["traffic"]["packing_bucket"]
        nlit = ref.packing(self.alarms, bucket)
        pairs = []
        for item in self.samples.items:
            states = ref.refresh(*item["alarm"], nlit)
            rats = rats_ref.refresh(item["alarm"][0])
            beats = item["updates"]
            pairs.append((
                (item["states"], [u[3] for u in beats], item["rats"],
                 [u[4] for u in beats]),
                (states, [ref.update(*states, self.ts[b], doy, utc)
                          for b, doy, utc, _, _ in beats], rats,
                 [rats_ref.update(rats, states[1], self.ts[b])
                  for b, _, _, _, _ in beats])))
        return pairs

    def compare(self, got, want):
        return worst([super().compare(got[:2], want[:2]),
                      compare_rats(got[2], want[2])]
                     + [compare_rats_update(g, w)
                        for g, w in zip(got[3], want[3])])
