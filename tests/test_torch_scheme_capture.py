"""The port's captured scheme entries (rrtmg_lw / rrtmg_sw, chou_sw /
chou_lw, rrtmgp_sw / rrtmgp_lw) and the nesting of captured entries
(driver/compiled.py), on the CPU at 8 columns x 72 levels on the
realistic scene, doy 172, 12 UTC.

On the CPU every entry runs its eager body (the caller asked for the
CPU); what is held here is what the captures on a card rely on:
- a captured entry called while another entry's body warms up or is
  captured runs its own body and records no graph, and LAUNCHES counts
  each kernel once per outer call; disable_capture() runs every entry's
  body; torch.cuda's stream and graph API are stood in for, as in
  tests/test_torch_step_capture.py;
- the key of each of the six entries holds its static values (the
  reference's static argnames, the table module, plain; mg and sb for
  rrtmgp_sw) and the traced tensors' shapes, and not doy's value; an
  array-valued indsolvar or bndscl is taken as a tuple, a tensor one and
  an unhashable static value are refused;
- a second Chou-Suarez, RRTMGP facade, RRTMGP native and RATS refresh
  makes no torch.as_tensor / torch.tensor / torch.from_numpy call on
  host data, indexes no tensor with a list, an array or a mask, builds
  no threefry key from a Python number and reads no tensor back to the
  host (Tensor.item, tolist, numpy, cpu, __array__, __bool__, __int__,
  __float__, __index__), outside the kernel wrappers, which on the CPU
  run their plain twins: on a card each of those would synchronise the
  stream, and none can be captured. Undoing a per-device cache these
  refreshes reach (tables.on_device, the McICA key, the slice that
  replaced the seeds' index list) makes it fail.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.config import Scheme
from geosradiation_gridcomp_tpu_torch.driver import compiled
from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import rats_refresh
from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
from geosradiation_gridcomp_tpu_torch.models import chou_lw as chou_lw_mod
from geosradiation_gridcomp_tpu_torch.models import chou_sw as chou_sw_mod
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import kdist, rte
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import scheme
from geosradiation_gridcomp_tpu_torch.ops import mcica, threefry
from geosradiation_gridcomp_tpu_torch.scene import example_inputs
from tests.test_torch_step_capture import _fake_cuda, _key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import save_kdist_npz, synthetic_kdist  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
T_CFG = TConfig()
# the kernel wrappers as the scheme modules call them
WRAPPERS = {lwm: ("mcica_optics_lw", "taumol_lw_fast", "rtrnmc_fast"),
            swm: ("mcica_optics_sw", "taumol_sw_fast", "spcvmc_fast"),
            kdist: ("taumol_lw_fast", "taumol_sw_fast"),
            rte: ("rtrnmc_fast",)}


@pytest.fixture(scope="module")
def scene():
    inp = example_inputs(NCOL, NLEV, device="cpu")
    ple0 = inp.ple[0].numpy()
    ict, icb = T_CFG.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    sw, lw = rad.reference_modules(torch.device("cpu"))
    return dict(inp=inp, ict=ict, icb=icb, sw=sw, lw=lw)


# --------------------------------------------------------------------------
# nesting
# --------------------------------------------------------------------------

def test_nested_entry_runs_its_body_and_records_no_graph(monkeypatch):
    """An entry called inside another's warm-up and capture runs its body
    (no graph of its own, its launches part of the outer graph's) and
    LAUNCHES counts each kernel once per outer call; alone it captures
    its own graph; under disable_capture() both run their bodies."""
    _fake_cuda(monkeypatch)
    cpu = lambda arguments, device: arguments
    runs = []

    def inner_body(x, k):
        LAUNCHES["inner"] += 1
        runs.append("inner")
        return x + k

    inner = compiled.Captured(inner_body, ("k",), route=cpu)

    def outer_body(x, s):
        LAUNCHES["outer"] += 1
        runs.append("outer")
        return inner(x * s, k=1.0)

    outer = compiled.Captured(outer_body, (), route=cpu)
    x = torch.arange(4.0)
    LAUNCHES.clear()
    got = outer(x, 2.0)
    assert torch.equal(got, x * 2.0 + 1.0)
    assert runs == ["outer", "inner"] * 2          # warm-up, capture
    assert inner.graphs == {} and len(outer.graphs) == 1
    assert dict(LAUNCHES) == {"outer": 1, "inner": 1}
    graph = next(iter(outer.graphs.values()))
    assert graph.launches == {"outer": 1, "inner": 1}
    for n in (2, 3):
        outer(x + n, 3.0)
        assert dict(LAUNCHES) == {"outer": n, "inner": n}
    assert len(runs) == 4 and inner.graphs == {}
    assert compiled._depth() == 0

    runs.clear()
    inner(x, k=2.0)
    assert runs == ["inner"] * 2 and len(inner.graphs) == 1
    assert dict(LAUNCHES) == {"outer": 3, "inner": 4}

    runs.clear()
    with compiled.disable_capture():
        assert torch.equal(outer(x, 5.0), x * 5.0 + 1.0)
        assert torch.equal(inner(x, k=7.0), x + 7.0)
    assert runs == ["outer", "inner", "inner"]
    assert len(outer.graphs) == 1 and len(inner.graphs) == 1
    assert dict(LAUNCHES) == {"outer": 4, "inner": 6}
    assert compiled._depth() == 0


def test_nesting_depth_unwinds_after_a_failed_capture(monkeypatch):
    _fake_cuda(monkeypatch)

    def body(x):
        raise RuntimeError("capture refused")

    entry = compiled.Captured(body, (), route=lambda a, d: a)
    with pytest.raises(RuntimeError, match="capture refused"):
        entry(torch.zeros(2))
    assert compiled._depth() == 0 and entry.graphs == {}


# --------------------------------------------------------------------------
# the keys of the six entries
# --------------------------------------------------------------------------

def _lw_args(scene, inp=None):
    inp = scene["inp"] if inp is None else inp
    play, h2o, o3 = rad._common_derived(inp)
    n = inp.t.shape[0]
    z = torch.zeros_like(inp.co2)
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    return (inp.ple, play, inp.t, tlev, inp.tsinst,
            inp.emis[:, None].expand(n, 16), h2o, o3, inp.co2, inp.ch4,
            inp.n2o, torch.full_like(z, 0.2095), z, inp.cfc11, inp.cfc12,
            inp.hcfc22, z, inp.fcld, ciwp, clwp, inp.ri, inp.rl, zm,
            inp.lats)


def _sw_args(scene, inp=None):
    inp = scene["inp"] if inp is None else inp
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    cosz = torch.clamp(torch.cos(inp.lats), min=0.0)
    return (inp.ple, play, inp.t, cosz, inp.albvr, inp.albvf, inp.albnr,
            inp.albnf, h2o, o3, inp.co2, inp.ch4,
            torch.full_like(inp.co2, 0.2095), inp.fcld, ciwp, clwp, inp.ri,
            inp.rl, zm, inp.lats)


def _rrtmgp_lw_args(scene, inp=None):
    a = _lw_args(scene, inp)
    return a[:3] + a[4:12] + a[13:16] + a[17:]


def _chou_sw_args(inp):
    cwc, reff = rad._cwc_reff(inp)
    cosz = torch.clamp(torch.cos(inp.lats), min=0.0)
    return (cosz, inp.ple, inp.t, inp.qv, inp.o3, inp.co2, cwc, inp.fcld,
            reff)


def _chou_lw_args(inp):
    cwc, reff = rad._cwc_reff(inp)
    n = inp.t.shape[0]
    return (inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
            inp.emis[:, None].expand(n, 10), inp.co2, inp.n2o, inp.ch4,
            inp.cfc11, inp.cfc12, inp.hcfc22, cwc, inp.fcld, reff)


def _assert_keys(entry, call, base_kw, changes, doy=True):
    """call(kw, doy, wide) -> the entry's key; the key is the same at
    another doy (a number or a 0-d tensor) and changes with every
    static change and with the shapes."""
    base = call(base_kw, DOY, False)
    if doy:
        assert call(base_kw, 10.5, False) == base
        assert call(base_kw, torch.tensor(3.25), False) == base
    keys = [call({**base_kw, **c}, DOY, False) for c in changes]
    keys.append(call(base_kw, DOY, True))
    assert base not in keys and len(set(keys)) == len(keys)
    static, traced = base
    names = dict(static)
    for k, v in base_kw.items():
        if k in entry.static_argnames:
            assert names[k] == v, k
    shapes = [s[1] for _, s in traced if isinstance(s, tuple)
              and s and s[0] == compiled.TENSOR]
    assert (NCOL, NLEV) in shapes
    return base


def test_rrtmg_lw_key(scene):
    wide = example_inputs(NCOL + 8, NLEV, device="cpu")
    other = lwm.RRTMGLW.from_reference_tables("cpu")

    def call(kw, doy, w):
        args = _lw_args(scene, wide if w else None)
        return _key(lwm.rrtmg_lw, kw.get("lw", scene["lw"]), *args, doy,
                    **{k: v for k, v in kw.items() if k != "lw"})
    base_kw = dict(iceflag=3, liqflag=1, dudts=True, cloud_mh=30,
                   cloud_lm=50, inhm=1, plain=False)
    changes = [dict(iceflag=2), dict(dudts=False), dict(cloud_mh=31),
               dict(cloud_lm=49), dict(inhm=2), dict(plain=True),
               dict(lw=other), dict(taua=torch.zeros(NCOL, NLEV, 16))]
    _assert_keys(lwm.rrtmg_lw, call, base_kw, changes)


def test_rrtmg_sw_key_and_static_weights(scene):
    wide = example_inputs(NCOL + 8, NLEV, device="cpu")
    entry = swm.rrtmg_sw

    def call(kw, doy, w):
        args = _sw_args(scene, wide if w else None)
        return _key(entry, scene["sw"], *args, doy, **kw)
    base_kw = dict(scon=1361.0, isolvar=-1, iceflag=3, cloud_mh=30,
                   cloud_lm=50, inhm=1, nlit=4, ncld=2, plain=False)
    changes = [dict(scon=1360.0), dict(isolvar=0), dict(iceflag=1),
               dict(nlit=None), dict(ncld=None), dict(inhm=0),
               dict(plain=True), dict(indsolvar=(0.16, 910.0)),
               dict(bndscl=tuple([1.0] * 14))]
    base = _assert_keys(entry, call, base_kw, changes)
    assert call(base_kw, 200.0, False) == base
    # adjes is traced like doy
    assert _key(entry, scene["sw"], *_sw_args(scene), DOY, adjes=0.97,
                **base_kw) == base
    # an array-valued indsolvar / bndscl is taken as a tuple by the route
    card = torch.device("cuda", 0)
    bound = entry.signature.bind(scene["sw"], *_sw_args(scene), DOY,
                                 indsolvar=np.array([0.16, 910.0]),
                                 bndscl=np.ones(14, np.float32))
    bound.apply_defaults()
    routed = entry.route(dict(bound.arguments), card)
    assert routed["indsolvar"] == (0.16, 910.0)
    assert routed["bndscl"] == tuple([1.0] * 14)
    assert entry.key(routed) == _key(entry, scene["sw"], *_sw_args(scene),
                                     DOY, indsolvar=(0.16, 910.0),
                                     bndscl=tuple([1.0] * 14))
    assert entry.route({**bound.arguments, "plain": True}, card) is None
    assert entry.route(dict(bound.arguments), torch.device("cpu")) is None
    with pytest.raises(TypeError, match="indsolvar is static"):
        entry.route({**bound.arguments, "indsolvar": torch.ones(2)}, card)
    with pytest.raises(TypeError, match="bndscl must hash"):
        call({**base_kw, "bndscl": [1.0] * 14}, DOY, False)


def test_chou_keys(scene):
    wide = example_inputs(NCOL + 8, NLEV, device="cpu")
    ict, icb = scene["ict"], scene["icb"]

    def sw_call(kw, doy, w):
        inp = wide if w else scene["inp"]
        return _key(chou_sw_mod.chou_sw, *_chou_sw_args(inp), **kw)
    _assert_keys(chou_sw_mod.chou_sw, sw_call, dict(ict=ict, icb=icb),
                 [dict(ict=ict + 1), dict(icb=icb - 1),
                  dict(hk_uv=torch.ones(5), hk_ir=torch.ones(3, 10)),
                  dict(taua=torch.zeros(NCOL, NLEV, 8),
                       ssaa=torch.zeros(NCOL, NLEV, 8),
                       asya=torch.zeros(NCOL, NLEV, 8))], doy=False)

    def lw_call(kw, doy, w):
        inp = wide if w else scene["inp"]
        return _key(chou_lw_mod.chou_lw, *_chou_lw_args(inp), **kw)
    _assert_keys(chou_lw_mod.chou_lw, lw_call,
                 dict(ict=ict, icb=icb, trace=True, with_aerosol=False),
                 [dict(ict=ict + 1), dict(icb=icb - 1), dict(trace=False),
                  dict(with_aerosol=True)], doy=False)


def test_rrtmgp_keys(scene):
    wide = example_inputs(NCOL + 8, NLEV, device="cpu")
    other = swm.RRTMGSW.from_reference_tables("cpu")

    def sw_call(kw, doy, w):
        args = _sw_args(scene, wide if w else None)
        return _key(scheme.rrtmgp_sw, kw.get("sw", scene["sw"]), *args, doy,
                    **{k: v for k, v in kw.items() if k != "sw"})
    _assert_keys(scheme.rrtmgp_sw, sw_call,
                 dict(mg=0.1567652, sb=909.7126, iceflag=3, liqflag=1,
                      inhm=1, kdist_path=None, plain=False),
                 [dict(mg=0.16), dict(sb=900.0), dict(iceflag=2),
                  dict(inhm=2), dict(kdist_path="sw.npz"), dict(plain=True),
                  dict(sw=other), dict(tsi_scale=torch.ones(NCOL))])

    def lw_call(kw, doy, w):
        args = _rrtmgp_lw_args(scene, wide if w else None)
        return _key(scheme.rrtmgp_lw, scene["lw"], *args, doy, **kw)
    base = _assert_keys(scheme.rrtmgp_lw, lw_call,
                        dict(iceflag=3, liqflag=1, inhm=1, dudts=True,
                             kdist_path=None, plain=False),
                        [dict(iceflag=2), dict(inhm=0), dict(dudts=False),
                         dict(kdist_path="lw.npz"), dict(plain=True)])
    # ccl4vmr / covmr are traced scalars, as doy
    assert _key(scheme.rrtmgp_lw, scene["lw"], *_rrtmgp_lw_args(scene), DOY,
                ccl4vmr=1e-10, covmr=torch.tensor(2e-7)) == base


# --------------------------------------------------------------------------
# host copies and read-backs on a second refresh
# --------------------------------------------------------------------------

def _counting(monkeypatch):
    """Count host-data tensor constructions (torch.as_tensor, tensor,
    from_numpy of a non-tensor; an index that is a list, an array or a
    mask; a threefry key built from a Python number) and reads back to
    the host made outside the kernel wrappers; returns the list they
    land in."""
    found, inside = [], []
    for name in ("as_tensor", "tensor", "from_numpy"):
        fn = getattr(torch, name)

        def counted(data, *args, _fn=fn, _name=name, **kwargs):
            if not inside and not isinstance(data, torch.Tensor):
                found.append(f"torch.{_name}({type(data).__name__})")
            return _fn(data, *args, **kwargs)
        monkeypatch.setattr(torch, name, counted)

    def host_index(index):
        items = index if isinstance(index, tuple) else (index,)
        return [type(i).__name__ for i in items
                if isinstance(i, (list, np.ndarray))
                or (isinstance(i, torch.Tensor) and i.dtype == torch.bool)]
    for name in ("__getitem__", "__setitem__"):
        fn = getattr(torch.Tensor, name)

        def indexed(self, index, *args, _fn=fn, _name=name):
            bad = [] if inside else host_index(index)
            if bad:
                found.append(f"Tensor.{_name}({', '.join(bad)})")
            return _fn(self, index, *args)
        monkeypatch.setattr(torch.Tensor, name, indexed)
    key = threefry.key

    def key_counted(*args, **kwargs):
        if not inside:
            found.append("threefry.key")
        return key(*args, **kwargs)
    monkeypatch.setattr(threefry, "key", key_counted)
    for name in ("item", "tolist", "numpy", "cpu", "__array__", "__bool__",
                 "__int__", "__float__", "__index__"):
        fn = getattr(torch.Tensor, name)

        def read(self, *args, _fn=fn, _name=name, **kwargs):
            if not inside:
                found.append(f"Tensor.{_name}")
            return _fn(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, read)
    for mod, names in WRAPPERS.items():
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*args, _fn=fn, **kwargs):
                inside.append(1)
                try:
                    return _fn(*args, **kwargs)
                finally:
                    inside.pop()
            monkeypatch.setattr(mod, name, wrapper)
    return found


@pytest.fixture(scope="module")
def kdist_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("kdist")
    paths = [str(d / f"rrtmgp_kdist_{b}.npz") for b in ("lw", "sw")]
    for p in paths:
        save_kdist_npz(synthetic_kdist(), p)
    return paths


def _refreshes(scene, kdist_paths):
    """name -> refresh(doy, utc) of the paths the scheme entries serve."""
    inp, ict, icb = scene["inp"], scene["ict"], scene["icb"]
    rrtmgp = dict(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    configs = {
        "chou": TConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU),
        "rrtmgp facade": TConfig(**rrtmgp),
        "rrtmgp native": TConfig(**rrtmgp, rrtmgp_kdist_lw=kdist_paths[0],
                                 rrtmgp_kdist_sw=kdist_paths[1],
                                 outputs=frozenset({"olrb"}))}
    out = {name: (lambda doy, utc, cfg=cfg: tstep.radiation_refresh(
        inp, doy, utc, config=cfg, ict=ict, icb=icb))
        for name, cfg in configs.items()}
    out["rats"] = lambda doy, utc: rats_refresh(inp, doy, T_CFG, ict, icb)
    return out


@pytest.mark.parametrize("path", ["chou", "rrtmgp facade", "rrtmgp native",
                                  "rats"])
def test_second_refresh_copies_nothing_from_the_host(scene, kdist_paths,
                                                     monkeypatch, path):
    refresh = _refreshes(scene, kdist_paths)[path]
    refresh(DOY, UTC)
    doy, utc = torch.tensor(DOY + 0.5), torch.tensor(UTC + 1.0)
    found = _counting(monkeypatch)
    refresh(doy, utc)
    assert found == []
    # the counters see what they are meant to see
    x = scene["inp"].t
    torch.as_tensor(np.zeros(2))
    x[:, [0, 1]]
    x[x > 250.0]
    threefry.key(0, device="cpu")
    float(x[0, 0])
    assert found == ["torch.as_tensor(ndarray)", "Tensor.__getitem__(list)",
                     "Tensor.__getitem__(Tensor)", "threefry.key",
                     "Tensor.__float__"]


def test_mcica_helpers_copy_nothing_on_a_second_call(scene, monkeypatch):
    """The seeds, the key and the default condensate columns of the McICA
    generator come from the device caches on a second call."""
    inp = scene["inp"]
    play = rad._common_derived(inp)[0]
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)

    def run():
        mcica.subcolumn_keys(play, swm.SEED_ORDER_SW)
        return mcica.generate_stochastic_clouds(
            zm, inp.lats, DOY, play, inp.fcld, ciwp, clwp, 1e-20,
            nsubcol=16, inhm=2)
    first = run()
    found = _counting(monkeypatch)
    second = run()
    assert found == []
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_state_seeds_equal_the_index_list_form(scene):
    """The slice-and-flip seeds equal the former list-index form."""
    play = rad._common_derived(scene["inp"])[0]
    for order in ((0, 1, 2, 3), swm.SEED_ORDER_SW, (1, 3, 0, 2)):
        want = play[..., [-1, -2, -3, -4]] * 100.0
        want = want[..., list(order)]
        want = ((want - torch.floor(want)) * mcica._MAXIMO + 1.0).to(
            torch.int64)
        assert torch.equal(mcica.state_seed_ints(play, order), want)
