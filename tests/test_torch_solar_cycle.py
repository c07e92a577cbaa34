"""The port's solar-cycle reader: the cases of tests/test_solar_cycle.py,
through the offline preprocessor tools/nrlssi2_prep.py and the port's
copy of the NRLSSI2 source weights, each result also equal to the
reference reader's."""

import datetime as dt
import os
import subprocess
import sys

import numpy as np

from geosradiation_gridcomp_tpu.driver import solar_cycle as ref
from geosradiation_gridcomp_tpu_torch.driver.solar_cycle import (
    SolarCycleData, read_solar_cycle_file)
from geosradiation_gridcomp_tpu_torch.models.rrtmg import nrlssi2 as nr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_sources(tmp_path):
    mg_sb = tmp_path / "model_input.txt"
    rows = []
    day0 = dt.date(2020, 1, 1)
    for i in range(10):
        d = day0 + dt.timedelta(days=i)
        rows.append((d, 0.155 + 1e-4 * i, 900.0 + 10.0 * i,
                     1360.5 + 0.05 * i))
    mg_sb.write_text("# header\n" + "".join(
        f"{d:%Y-%m-%d} {mg:.6f} {sb:.4f}\n" for d, mg, sb, _ in rows))
    tsi = tmp_path / "tsi_daily.csv"
    # drop two days from TSI to exercise the intersection
    tsi.write_text("".join(
        f"{d:%Y%m%d},{t:.3f}\n" for d, _, _, t in rows[:4] + rows[6:]))
    return mg_sb, tsi


def test_prep_and_read_roundtrip(tmp_path):
    mg_sb, tsi = _write_sources(tmp_path)
    out = tmp_path / "NRLSSI2.txt"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "nrlssi2_prep.py"),
         "--mg-sb", str(mg_sb), "--tsi", str(tsi), "-o", str(out)],
        check=True)
    data = read_solar_cycle_file(str(out))
    assert len(data.days) == 8          # intersection drops 2 days
    t, mg, sb = data.at(dt.datetime(2020, 1, 1, 12))
    assert t == np.float64(1360.5) and mg == 0.155 and sb == 900.0
    expect = ref.read_solar_cycle_file(str(out))
    for f in ("days", "tsi", "mg", "sb"):
        np.testing.assert_array_equal(getattr(data, f), getattr(expect, f))
    for hour in (0, 7, 12, 18):
        for day in (1, 3, 5, 9, 12):
            when = dt.datetime(2020, 1, day, hour)
            assert data.at(when) == expect.at(when)


def test_time_interpolation_between_noons():
    days = np.array([dt.date(2021, 6, 1).toordinal(),
                     dt.date(2021, 6, 2).toordinal()])
    arrays = dict(days=days, tsi=np.array([1360.0, 1362.0]),
                  mg=np.array([0.15, 0.16]), sb=np.array([800., 900.]))
    d = SolarCycleData(**arrays)
    t, mg, sb = d.at(dt.datetime(2021, 6, 2, 0))
    assert t == 1361.0 and np.isclose(mg, 0.155) and sb == 850.0
    assert d.at(dt.datetime(2021, 7, 1, 12))[0] == 1362.0
    assert d.at(dt.datetime(2021, 5, 1, 12))[0] == 1360.0
    r = ref.SolarCycleData(**arrays)
    for doy in (120.0, 152.25, 152.5, 153.0, 153.9, 200.0):
        assert d.at_doy(2021, doy) == r.at_doy(2021, doy)


def test_isolvar2_consumes_file_indices():
    """The Mg/SB from a cycle file drive the port's isolvar=2 weights, with
    scon honored exactly (rrtmg_sw_rad.F90:1090-1101)."""
    days = np.array([dt.date(2021, 6, 1).toordinal()])
    d = SolarCycleData(days=days, tsi=np.array([1359.2]),
                       mg=np.array([0.158]), sb=np.array([1000.0]))
    tsi, mg, sb = d.at_doy(2021, 152.5)
    w = nr.solar_source_weights(2, tsi, indsolvar=(mg, sb))
    got = w.w_irr[0] * nr.IINT + w.w_fac[0] * nr.FINT + w.w_sns[0] * nr.SINT
    assert np.isclose(got, tsi, rtol=1e-12)
