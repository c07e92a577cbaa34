"""The port's RATS diagnostics (LW re-solves with one trace gas zeroed at
a time) against the JAX CPU oracle on the realistic scene (8 columns x 72
levels, seed 0), with the plain twins of K1, K3 and K4.

Gates (relmax = max|a-b| / max|b|, tools/verify_tpu.py:33-36): every
gas's RatsState fields and the rats_update outputs <= 5e-5 (the LW
end-to-end gate, tools/verify_tpu.py:243); with each gas zeroed, the full
RRTMG-LW solve's McICA clear counts equal and every flux <= 5e-5, and K3's
twin (taumol) within 5e-6 of the oracle's in every band (the bound
tests/test_torch_lw_optics.py holds it to on the unzeroed scene): a zeroed
key species drives specparm onto 0 or its ONEMINUS clamp, and zero water
reaches setcoef's water terms and the continuum. The forcing signs are
those of tests/test_diagnostics.py:51-78.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig
from geosradiation_gridcomp_tpu.driver import diagnostics as jdg
from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.models.rrtmg import lw as jlw
from geosradiation_gridcomp_tpu.models.rrtmg.setcoef_lw import \
    setcoef_lw as j_setcoef
from geosradiation_gridcomp_tpu.models.rrtmg.tables_lw import NGS_LW
from geosradiation_gridcomp_tpu.models.rrtmg.taumol_lw import \
    taumol_lw as j_taumol
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.driver import diagnostics as tdg
from geosradiation_gridcomp_tpu_torch.driver import radiation as trad
from geosradiation_gridcomp_tpu_torch.driver.state import RatsState
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as tlw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
    setcoef_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import taumol_lw
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY = 8, 72, 172.0
GASES = tdg.RATS_GASES
FIELD = {"H2O": "qv", "O3": "o3", "CO2": "co2", "CH4": "ch4", "N2O": "n2o",
         "CFC11": "cfc11", "CFC12": "cfc12", "HCFC22": "hcfc22"}


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


@pytest.fixture(scope="module")
def runs():
    """Both packages' RATS refresh over all 8 gases, their main irrad
    refresh and rats_update at Ts + 0.5 K."""
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    lw = tlw.RRTMGLW.from_reference_tables("cpu")
    jr = jdg.rats_refresh(ji, DOY, cfg, ict, icb)
    tr = tdg.rats_refresh(ti, DOY, TConfig(), ict, icb, lw=lw)
    ji_irr = jrad.irrad_refresh(ji, DOY, cfg, ict, icb)
    ti_irr = trad.irrad_refresh(ti, DOY, TConfig(), ict, icb, lw=lw)
    ju = jdg.rats_update(jr, ji_irr, ji.tsinst + 0.5)
    tu = tdg.rats_update(tr, ti_irr, ti.tsinst + 0.5)
    return dict(ji=ji, ti=ti, ict=ict, icb=icb, lw=lw, jr=jr, tr=tr,
                ju=ju, tu=tu, ti_irr=ti_irr)


@pytest.mark.parametrize("gas", GASES)
def test_rats_state_per_gas(runs, gas):
    g = GASES.index(gas)
    jr, tr = runs["jr"], runs["tr"]
    for f in RatsState._fields:
        a, b = getattr(tr, f)[g], np.asarray(getattr(jr, f))[g]
        assert tuple(a.shape) == b.shape, f
        assert relmax(a.numpy(), b) <= 5e-5, (gas, f)


def test_rats_state_shapes_and_order(runs):
    tr = runs["tr"]
    assert tr.flx.shape == (8, NCOL, NLEV + 1)
    assert tr.sfcem.shape == (8, NCOL)
    # each entry differs from the all-gas solve: the gas was zeroed
    flx = runs["ti_irr"].flx
    for g in range(8):
        assert not torch.equal(tr.flx[g], flx), GASES[g]


def test_rats_update_matches_oracle(runs):
    for a, b in zip(runs["tu"], runs["ju"]):
        assert relmax(a.numpy(), np.asarray(b)) <= 5e-5


def test_rats_forcing_signs(runs):
    """Zeroing CO2 raises the OLR: forcing = F_all - F_zeroed > 0 at TOA
    (tests/test_diagnostics.py:51-68); CH4's is smaller but positive."""
    f = runs["tu"][1].numpy()
    co2, ch4 = f[GASES.index("CO2"), :, 0], f[GASES.index("CH4"), :, 0]
    assert (co2 > 0.5).all()
    assert (ch4 > -0.05).all() and ch4.mean() > 0.05
    assert (co2 > ch4).all()


def test_rats_ts_advance_matches_refresh_at_zero_delt(runs):
    tr, ti = runs["tr"], runs["ti"]
    flx_rat, _ = tdg.rats_update(tr, runs["ti_irr"], ti.tsinst)
    np.testing.assert_allclose(flx_rat.numpy(), tr.flx.numpy(), rtol=0,
                               atol=1e-6)


def test_rats_subset_and_unknown_gas(runs):
    ti = runs["ti"]
    sub = tdg.rats_refresh(ti, DOY, TConfig(), runs["ict"], runs["icb"],
                           gases=("CH4", "O3"), lw=runs["lw"])
    full = runs["tr"]
    for f in RatsState._fields:
        assert torch.equal(getattr(sub, f)[0],
                           getattr(full, f)[GASES.index("CH4")])
        assert torch.equal(getattr(sub, f)[1],
                           getattr(full, f)[GASES.index("O3")])
    with pytest.raises(ValueError, match="unknown RATS gas"):
        tdg.rats_refresh(ti, DOY, TConfig(), runs["ict"], runs["icb"],
                         gases=("CO2", "SF6"), lw=runs["lw"])


def test_rats_refresh_builds_the_tables_once(runs, monkeypatch):
    """The LW tables are built once per device (radiation.
    reference_modules) and shared by every solve of every RATS refresh:
    on a card the solves then replay one rrtmg_lw graph."""
    built = []
    orig = tlw.RRTMGLW.from_reference_tables

    def counted(device="cuda"):
        built.append(device)
        return orig(device)
    monkeypatch.setattr(tlw.RRTMGLW, "from_reference_tables", counted)
    monkeypatch.setattr(trad, "reference_modules", functools.lru_cache(
        maxsize=None)(trad.reference_modules.__wrapped__))
    ti = runs["ti"]
    for _ in range(2):
        st = tdg.rats_refresh(ti, DOY, TConfig(), runs["ict"], runs["icb"],
                              gases=("H2O", "CO2", "N2O"))
    assert built == [ti.t.device]
    assert torch.equal(st.flx[1], runs["tr"].flx[GASES.index("CO2")])


def _lw_args(inp, mod, xp):
    """rrtmg_lw's positional inputs as irrad_refresh builds them."""
    play, h2o, o3 = mod._common_derived(inp)
    ncol = inp.t.shape[0]
    if xp is jnp:
        emis = jnp.broadcast_to(inp.emis[:, None], (ncol, 16))
        full = jnp.full_like
        zeros = jnp.zeros_like
    else:
        emis = inp.emis[:, None].expand(ncol, 16)
        full = torch.full_like
        zeros = torch.zeros_like
    lwm = jlw if xp is jnp else tlw
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = mod._incloud_paths(inp)
    return (inp.ple, play, inp.t, tlev, inp.tsinst, emis, h2o, o3, inp.co2,
            inp.ch4, inp.n2o, full(inp.co2, 0.2095), zeros(inp.co2),
            inp.cfc11, inp.cfc12, inp.hcfc22, zeros(inp.co2), inp.fcld,
            ciwp, clwp, inp.ri, inp.rl, zm, inp.lats, DOY)


def _zeroed(inp, gas, xp):
    field = FIELD[gas]
    return inp._replace(**{field: xp.zeros_like(getattr(inp, field))})


@pytest.mark.parametrize("gas", GASES)
def test_rrtmg_lw_with_gas_zeroed(runs, gas):
    """The whole LW solve with the gas zeroed: McICA clear counts equal,
    every output within the LW gate."""
    ji, ti = _zeroed(runs["ji"], gas, jnp), _zeroed(runs["ti"], gas, torch)
    kw = dict(cloud_mh=runs["ict"], cloud_lm=runs["icb"])
    jo = jlw.rrtmg_lw(*_lw_args(ji, jrad, jnp), **kw)
    to = tlw.rrtmg_lw(runs["lw"], *_lw_args(ti, trad, torch), **kw)
    np.testing.assert_array_equal(to["clear_counts"].numpy(),
                                  np.asarray(jo["clear_counts"]))
    for k in jo:
        if k != "clear_counts":
            assert relmax(to[k].numpy(), np.asarray(jo[k])) <= 5e-5, k


@pytest.mark.parametrize("gas", GASES)
def test_taumol_twin_with_gas_zeroed(runs, gas):
    """K3's twin at the edges the zeroed gas drives it to: taug and the
    Planck fractions within 5e-6 of the oracle's in every band."""
    ji, ti = _zeroed(runs["ji"], gas, jnp), _zeroed(runs["ti"], gas, torch)
    ja = _lw_args(ji, jrad, jnp)
    ta = _lw_args(ti, trad, torch)
    jc = j_setcoef(ja[1], ji.t, ji.ple * 0.01, *ja[3:17])
    coefs = setcoef_lw(ta[1], ti.t, ti.ple * 0.01, *ta[3:17],
                       runs["lw"].planck_tables)
    jtg, jpf = j_taumol(jc)
    tg, pf = taumol_lw(coefs, runs["lw"].taumol_tables)
    for band in range(16):
        sl = slice(NGS_LW[band], NGS_LW[band + 1])
        assert relmax(tg[..., sl].numpy(), np.asarray(jtg)[..., sl]) <= 5e-6, \
            band + 1
        assert relmax(pf[..., sl].numpy(), np.asarray(jpf)[..., sl]) <= 5e-6, \
            band + 1
