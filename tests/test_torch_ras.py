"""isca_tpu_torch's relaxed Arakawa-Schubert convection (physics/ras.py)
against isca_tpu.

* RAS on tests/test_ras.py's conditionally unstable soundings cut to 12
  levels (and a stable, a saturated-parcel and a very dry column beside
  them) in its
  options (the defaults, cufric, tokioka_on with rh_trig and krmax,
  top-down cloud order without evaporation, cold columns that snow with
  Goff-Gratch saturation), every field of the result
  at rtol 1e-10 with atol 1e-10 of each field's largest entry; klcl
  exactly.
* comp_lcl exactly, on columns with and without an LCL in the column (a
  saturated parcel, a parcel so dry its LCL lies above the top, which
  comp_lcl puts at its floor L//2-1).
* The port held to tests/goldens/bl_goldens.json's `ras` entry at
  tests/test_bl_goldens.py's tolerance (rtol 1e-7, atol 1e-7 x the
  field's largest entry), and its heating/drying consistency check.
* The physical checks of tests/test_ras.py, on the port.
* Float32: the port's float32 RAS within 3x isca_tpu's own
  float32-versus-float64 difference of isca_tpu's float64 result (plus
  1e-7 of the field's largest entry).
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.constants import EARTH
from isca_tpu.physics import ras as jras
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu_torch.physics import ras as tras
from isca_tpu_torch.physics import sat_vapor_pres as tsvp

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_ras import make_sounding  # noqa: E402

RTOL = 1e-10
GOLDEN_RTOL = 1e-7          # tests/test_bl_goldens.py RTOL
DT = 1200.0


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a, np.float64)).to(dtype)


def close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def soundings(L=12):
    """make_sounding's 3 unstable columns, a stable cold dry one, one with a
    saturated parcel and one with a very dry parcel (6 columns), on L
    levels (12: 9 cloud types)."""
    t, q, u, v, pf, ph, zh, svp = make_sounding(L=L, ncol=3)
    ts, qs_, *_ = make_sounding(L=L, ncol=1, t_sfc=270.0, rh=0.2, lapse=4.0e-3)
    t = np.concatenate([np.asarray(t), np.asarray(ts), np.asarray(t[:2])])
    q = np.concatenate([np.asarray(q), np.asarray(qs_), np.asarray(q[:2])])
    pf_np = np.asarray(pf)[0]
    qsat = np.asarray(svp.qs(jnp.asarray(t[4, -1]), pf_np[-1]))
    q[4, -1] = qsat                   # saturated parcel: LCL at the parcel
    q[5, -1] = 1e-7                   # LCL above the model top
    rng = np.random.default_rng(5)
    u = rng.normal(0.0, 5.0, t.shape)
    v = rng.normal(0.0, 5.0, t.shape)
    tile = lambda a: np.broadcast_to(np.asarray(a)[:1], (t.shape[0],) + np.asarray(a).shape[1:])
    return t, q, u, v, tile(pf), tile(ph), tile(zh)


OPTIONS = [dict(), dict(cufric=True), dict(tokioka_on=True, rh_trig=0.9, krmax=4),
           dict(botop=False, evap_on=False)]


@pytest.mark.parametrize("kw", OPTIONS)
def test_ras_matches(kw):
    t, q, u, v, pf, ph, zh = soundings()
    jsv = jsvp.SatVaporPres(constants=EARTH, do_simple=True)
    ref = jras.RAS(jras.RASConfig(**kw), jsv)(DT, *map(jnp.asarray, (t, q, u, v, pf, ph, zh)))
    got = tras.RAS(tras.RASConfig(**kw), tsvp.SatVaporPres(do_simple=True))(
        DT, *map(T, (t, q, u, v, pf, ph, zh)))
    assert float(np.asarray(ref.rain).max()) > 0.0
    assert got.klcl.dtype == torch.int32
    assert np.array_equal(got.klcl.numpy(), np.asarray(ref.klcl))
    for name in ("dt_t", "dt_q", "dt_u", "dt_v", "rain", "snow", "precip_ev"):
        close(getattr(got, name), getattr(ref, name), what=name)
    if kw.get("cufric"):
        assert float(np.abs(np.asarray(ref.dt_u)).max()) > 0.0


def test_ras_cold_columns_and_goff_gratch():
    t, q, u, v, pf, ph, zh = soundings()
    cold = np.array([True, False, True, False, False, True])
    jsv = jsvp.SatVaporPres(constants=EARTH, do_simple=False)
    ref = jras.RAS(jras.RASConfig(), jsv)(DT, *map(jnp.asarray, (t, q, u, v, pf, ph, zh)),
                                          coldT=jnp.asarray(cold))
    got = tras.RAS(tras.RASConfig(), tsvp.SatVaporPres(do_simple=False))(
        DT, *map(T, (t, q, u, v, pf, ph, zh)), coldT=torch.as_tensor(cold))
    assert float(np.asarray(ref.snow).max()) > 0.0
    for name in ("dt_t", "dt_q", "rain", "snow", "precip_ev"):
        close(getattr(got, name), getattr(ref, name), what=name)


def test_comp_lcl_matches_with_and_without_lcl():
    t, q, u, v, pf, ph, zh = soundings()
    jsv = jsvp.SatVaporPres(constants=EARTH, do_simple=True)
    jr = jras.RAS(jras.RASConfig(), jsv)
    tr_ = tras.RAS(tras.RASConfig(), tsvp.SatVaporPres(do_simple=True))
    args = (t[:, -1], q[:, -1], pf[:, -1], pf)
    ref = np.asarray(jr.comp_lcl(*map(jnp.asarray, args)))
    got = tr_.comp_lcl(*map(T, args)).numpy()
    assert np.array_equal(got, ref)
    L = t.shape[-1]
    assert got[4] == L - 1                  # saturated parcel
    assert got[5] == L // 2 - 1             # no LCL inside the column: the floor


def test_ras_matches_golden():
    with open(REPO / "tests" / "goldens" / "bl_goldens.json") as f:
        golden = json.load(f)["ras"]
    t, q, u, v, pf, ph, zh, _ = make_sounding()
    res = tras.RAS(tras.RASConfig(), tsvp.SatVaporPres(do_simple=True))(
        DT, *map(T, (t, q, u, v, pf, ph, zh)))
    for key, want in golden.items():
        want = np.asarray(want)
        np.testing.assert_allclose(getattr(res, key).numpy(), want, rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_RTOL * max(1.0, float(np.abs(want).max())),
                                   err_msg=key)
    # tests/test_bl_goldens.py test_ras_heating_drying_consistency
    dp = np.asarray(ph)[..., 1:] - np.asarray(ph)[..., :-1]
    dq_int = np.sum(res.dt_q.numpy() * dp / EARTH.grav, axis=-1)
    dt_int = np.sum(res.dt_t.numpy() * dp / EARTH.grav * EARTH.cp_air, axis=-1)
    assert np.all(res.rain.numpy() > 0)
    np.testing.assert_allclose(dt_int, -EARTH.hlv * dq_int, rtol=0.35)


def test_float32_within_three_times_isca_tpus_gap():
    t, q, u, v, pf, ph, zh = soundings()
    args = (t, q, u, v, pf, ph, zh)
    jsv = jsvp.SatVaporPres(constants=EARTH, do_simple=True)
    ref64 = jras.RAS(jras.RASConfig(), jsv)(DT, *map(jnp.asarray, args))
    ref32 = jras.RAS(jras.RASConfig(), jsv)(DT, *(jnp.asarray(a, jnp.float32) for a in args))
    got = tras.RAS(tras.RASConfig(), tsvp.SatVaporPres(do_simple=True))(
        DT, *(T(a, torch.float32) for a in args))
    assert got.dt_t.dtype == torch.float32
    assert np.array_equal(got.klcl.numpy(), np.asarray(ref64.klcl))
    for name in ("dt_t", "dt_q", "rain", "precip_ev"):
        want = np.asarray(getattr(ref64, name), np.float64)
        gap = float(np.abs(np.asarray(getattr(ref32, name), np.float64) - want).max())
        err = float(np.abs(getattr(got, name).numpy().astype(np.float64) - want).max())
        assert err <= 3.0 * gap + 1e-7 * float(np.abs(want).max()), (name, err, gap)


# ---------------------------------------------------------------------------
# the physical checks of tests/test_ras.py
# ---------------------------------------------------------------------------

def port_sounding(**kw):
    t, q, u, v, pf, ph, zh, _ = make_sounding(**kw)
    return tuple(map(T, (t, q, u, v, pf, ph, zh)))


def port_ras(**cfg):
    return tras.RAS(tras.RASConfig(**cfg), tsvp.SatVaporPres(constants=EARTH, do_simple=True))


def port_run(dt=DT, cfg=None, **sound_kw):
    t, q, u, v, pf, ph, zh = port_sounding(**sound_kw)
    return port_ras(**(cfg or {}))(dt, t, q, u, v, pf, ph, zh), (t, q, pf, ph)


def test_lcl_reasonable():
    t, q, u, v, pf, ph, zh = port_sounding()
    k = port_ras().comp_lcl(t[..., -1], q[..., -1], pf[..., -1], pf).numpy()
    L = t.shape[-1]
    assert np.all(k >= L // 2 - 1) and np.all(k <= L - 1)
    assert 7.0e4 < float(pf[0, k[0]]) <= 1.0e5


def test_dry_parcel_lcl_higher():
    t, q, u, v, pf, ph, zh = port_sounding()
    ras = port_ras()
    k_moist = ras.comp_lcl(t[..., -1], q[..., -1], pf[..., -1], pf)
    k_dry = ras.comp_lcl(t[..., -1], 0.3 * q[..., -1], pf[..., -1], pf)
    assert bool((k_dry <= k_moist).all())


def test_unstable_column_precipitates_and_stabilizes():
    res, (t, q, pf, ph) = port_run()
    assert bool(torch.isfinite(res.dt_t).all()) and bool(torch.isfinite(res.dt_q).all())
    assert bool((res.rain > 0.0).all())
    dp = ph[..., 1:] - ph[..., :-1]
    assert bool((torch.sum(res.dt_q * dp / EARTH.grav, dim=-1) < 0.0).all())
    assert bool((torch.sum(res.dt_t * dp / EARTH.grav * EARTH.cp_air, dim=-1) > 0.0).all())


def test_moisture_closure():
    res, (t, q, pf, ph) = port_run()
    dp = (ph[..., 1:] - ph[..., :-1]).numpy()
    dq_int = -np.sum(res.dt_q.numpy() * dp / EARTH.grav, axis=-1)
    np.testing.assert_allclose(dq_int, res.rain.numpy(), rtol=2e-3, atol=1e-7)


def test_stable_column_inactive():
    res, _ = port_run(t_sfc=270.0, rh=0.2, lapse=4.0e-3)
    assert float(res.rain.abs().max()) <= 1e-10 and float(res.dt_t.abs().max()) <= 1e-8


def test_relaxation_partial_adjustment():
    weak, _ = port_run(cfg=dict(rasal0=0.05))
    strong, _ = port_run(cfg=dict(rasal0=0.5))
    assert float(strong.rain.sum()) > float(weak.rain.sum())


def test_evaporation_moistens_subcloud_dry_layers():
    on, _ = port_run(cfg=dict(evap_on=True))
    off, _ = port_run(cfg=dict(evap_on=False))
    assert float(on.precip_ev.sum()) > 0.0
    assert float(on.rain.sum()) < float(off.rain.sum())


def test_snow_when_cold():
    t, q, u, v, pf, ph, zh = port_sounding()
    res = port_ras()(DT, t, q, u, v, pf, ph, zh, coldT=torch.tensor([True, False, False]))
    assert float(res.snow[0]) > 0.0 and float(res.rain[0]) == 0.0
    assert float(res.rain[1]) > 0.0 and float(res.snow[1]) == 0.0
