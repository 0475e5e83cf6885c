"""isca_tpu_torch against isca_tpu: package guards and the dycore, constants,
saturation, astronomy and grey-radiation modules.

Inputs are made with numpy from a seed and go through both packages at
float64 on the CPU. Unless a test says otherwise the tolerance is rtol=1e-12:
both sides do the same float64 arithmetic in the same order, so they differ
only by the last bits of libm functions (exp, log, pow) and summation order.
"""

import ast
import dataclasses
import filecmp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isca_tpu_torch
from isca_tpu import constants as jconst
from isca_tpu.dycore import press_geopot as jpg
from isca_tpu.dycore import time_integration as jti
from isca_tpu.dycore import vert_coordinate as jvc
from isca_tpu.physics import astronomy as jastro
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu.physics import two_stream_gray as jtsg
from isca_tpu_torch import constants as tconst
from isca_tpu_torch.dycore import press_geopot as tpg
from isca_tpu_torch.dycore import time_integration as tti
from isca_tpu_torch.dycore import vert_coordinate as tvc
from isca_tpu_torch.physics import astronomy as tastro
from isca_tpu_torch.physics import sat_vapor_pres as tsvp
from isca_tpu_torch.physics import two_stream_gray as ttsg

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-12


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=RTOL, atol=0.0, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def columns(seed=0, shape=(2, 4), L=8):
    """Level-last test columns: sigma levels, a lapse-rate T profile with
    noise, humidity near saturation at the bottom."""
    rng = np.random.default_rng(seed)
    _, bk = jvc.uneven_sigma(L, 6.0, 0.5, 7.5)
    ps = 1.0e5 + rng.uniform(-2e3, 2e3, shape)
    p_half = bk * ps[..., None]
    p_full = 0.5 * (p_half[..., 1:] + p_half[..., :-1])
    p_full[..., 0] = p_half[..., 1] / np.e
    t = np.maximum(295.0 * (p_full / 1e5) ** 0.19, 200.0) + rng.uniform(-3, 3, shape + (L,))
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(0.85 * 0.622 * es / p_full, 0.02) * rng.uniform(0.6, 1.1, shape + (L,))
    return dict(p_half=p_half, p_full=p_full, t=t, q=q,
                lat=np.deg2rad(rng.uniform(-70, 70, shape)),
                lon=np.deg2rad(rng.uniform(0, 360, shape)),
                t_surf=t[..., -1] + rng.uniform(-2, 4, shape))


# ---------------------------------------------------------------------------
# package guards
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_isca_tpu():
    files = sorted((REPO / "isca_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "isca_tpu")]
    assert not bad, bad


def test_k_tables_identical_to_isca_tpu():
    assert filecmp.cmp(REPO / "isca_tpu" / "data" / "rrtmg_sw.npz",
                       REPO / "isca_tpu_torch" / "data" / "rrtmg_sw.npz", shallow=False)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isca_tpu_torch.resolve_device()
    from isca_tpu_torch.models.column import ColumnModel
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnModel()
    assert isca_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# ---------------------------------------------------------------------------
# constants, vert_coordinate, press_geopot, time_integration
# ---------------------------------------------------------------------------

def test_constants_match():
    for name in ("EARTH", "JUPITER_LIKE"):
        j, t = getattr(jconst, name), getattr(tconst, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.zvir == t.zvir


@pytest.mark.parametrize("option,levels,kw", [
    ("even_sigma", 10, {}),
    ("uneven_sigma", 25, dict(scale_heights=6.0, surf_res=0.5, exponent=7.5)),
    ("hybrid", 20, {}),
    ("input", 3, dict(pk=[0.0, 10.0, 0.0, 0.0], bk=[0.0, 0.2, 0.6, 1.0])),
    ("mcm", 14, {}),
    ("v197", 18, {}),
])
def test_vert_coordinate_matches(option, levels, kw):
    jpk, jbk = jvc.compute_vert_coord(option, levels, **kw)
    tpk, tbk = tvc.compute_vert_coord(option, levels, **kw)
    np.testing.assert_array_equal(tpk, jpk)
    np.testing.assert_array_equal(tbk, jbk)


@pytest.mark.parametrize("option", ["simmons_and_burridge", "mcm"])
@pytest.mark.parametrize("top_is_zero", [True, False])
def test_press_geopot_matches(option, top_is_zero):
    rng = np.random.default_rng(1)
    pk, bk = jvc.uneven_sigma(8, 6.0, 0.5, 7.5, zero_top=top_is_zero)
    ps = 1e5 + rng.uniform(-3e3, 3e3, (2, 4))
    ref = jpg.pressure_variables(jnp, jnp.asarray(pk), jnp.asarray(bk), jnp.asarray(ps),
                                 top_is_zero, option)
    out = tpg.pressure_variables(T(pk), T(bk), T(ps), top_is_zero, option)
    for a, b, name in zip(out, ref, ("p_half", "ln_p_half", "p_full", "ln_p_full")):
        close(a, b, msg=name)
    tv = 250.0 + rng.uniform(-20, 20, (2, 4, 8))
    surf = rng.uniform(0, 500, (2, 4))
    for p_half in (None, "given"):
        jp = ref[0] if p_half else None
        tp = out[0] if p_half else None
        jg = jpg.compute_geopotential(jnp, 287.04, jnp.asarray(tv), ref[1], ref[3],
                                      jnp.asarray(surf), top_is_zero, p_half=jp)
        tg = tpg.compute_geopotential(287.04, T(tv), out[1], out[3], T(surf),
                                      top_is_zero, p_half=tp)
        # cumulative sums of increments with mixed signs: rtol 1e-12 of the
        # largest geopotential, not of each entry
        scale = float(np.abs(np.asarray(jg[1])).max())
        for a, b in zip(tg, jg):
            close(a, b, rtol=0.0, atol=1e-12 * scale)
    close(tpg.virtual_temperature(T(tv), T(tv * 1e-5), 0.608),
          jpg.virtual_temperature(jnp.asarray(tv), jnp.asarray(tv * 1e-5), 0.608))


def test_time_integration_matches():
    rng = np.random.default_rng(2)
    prev, curr, tend = (rng.normal(size=(2, 4, 8)) for _ in range(3))
    for raw in (1.0, 0.53):
        j = jti.leapfrog(jti.TwoLevel(jnp.asarray(prev), jnp.asarray(curr)),
                         jnp.asarray(tend), 1200.0, 0.03, raw)
        t = tti.leapfrog(tti.TwoLevel(T(prev), T(curr)), T(tend), 1200.0, 0.03, raw)
        close(t.prev, j.prev)
        close(t.curr, j.curr)
        ja, jP = jti.leapfrog_part_a(jti.TwoLevel(jnp.asarray(prev), jnp.asarray(curr)),
                                     jnp.asarray(tend), 1200.0, 0.04, raw)
        ta, tP = tti.leapfrog_part_a(tti.TwoLevel(T(prev), T(curr)), T(tend), 1200.0,
                                     0.04, raw)
        close(tP, jP)
        close(ta.curr, ja.curr)
        jb = jti.leapfrog_part_b(ja, jP, 0.04, raw)
        tb = tti.leapfrog_part_b(ta, tP, 0.04, raw)
        close(tb.prev, jb.prev)
        close(tb.curr, jb.curr)


# ---------------------------------------------------------------------------
# sat_vapor_pres, astronomy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("do_simple", [True, False])
def test_sat_vapor_pres_matches(do_simple):
    c = columns(3)
    j = jsvp.SatVaporPres(do_simple=do_simple)
    t = tsvp.SatVaporPres(do_simple=do_simple)
    tt = np.concatenate([c["t"].ravel(), np.linspace(180.0, 320.0, 57)])
    p = np.resize(c["p_full"].ravel(), tt.shape)
    close(t.es(T(tt)), j.es(jnp.asarray(tt)))
    close(t.des_dt(T(tt)), j.des_dt(jnp.asarray(tt)), rtol=1e-9 if not do_simple else RTOL)
    close(t.qs(T(tt), T(p)), j.qs(jnp.asarray(tt), jnp.asarray(p)))
    for a, b in zip(t.qs_and_dqsdt(T(tt), T(p)), j.qs_and_dqsdt(jnp.asarray(tt), jnp.asarray(p))):
        # the full scheme's dqs/dT is a centred difference of es: its
        # cancellation turns last-bit differences of es into ~1e-10 relative
        close(a, b, rtol=1e-9 if not do_simple else RTOL)


@pytest.mark.parametrize("ecc", [0.0, 0.0167])
@pytest.mark.parametrize("dt_radians", [None, 2 * np.pi / 144, 2 * np.pi])
def test_astronomy_matches(ecc, dt_radians):
    c = columns(4)
    jo, to = jastro.Orbit(ecc=ecc), tastro.Orbit(ecc=ecc)
    jax_solar = jax.jit(lambda lat, lon, gmt, tsae: jastro.diurnal_solar(
        jo, lat, lon, gmt, tsae, dt_radians))
    for tsae in (0.3, 2.0, 5.5):
        for gmt in (0.0, 1.7, 4.0):
            jr = jax_solar(jnp.asarray(c["lat"]), jnp.asarray(c["lon"]), gmt, tsae)
            tr = tastro.diurnal_solar(to, T(c["lat"]), T(c["lon"]), gmt, tsae, dt_radians)
            for a, b in zip(tr, jr):
                close(a, b, atol=1e-14)
    for a, b in zip(tastro.daily_mean_solar(to, T(c["lat"]), 1.1),
                    jastro.daily_mean_solar(jo, jnp.asarray(c["lat"]), 1.1)):
        close(a, b, atol=1e-14)
    close(tastro.annual_mean_p2_insolation(1360.0, T(c["lat"]), 1.4, 0.1),
          jastro.annual_mean_p2_insolation(1360.0, jnp.asarray(c["lat"]), 1.4, 0.1))


def test_astronomy_float32_clock():
    """The column model's clock is a float32 0-d tensor in both packages, so
    the declination is computed in float32: the two packages' float32 sin and
    asin may differ in the last bit (6e-8), hence rtol 1e-6 here."""
    c = columns(5)
    for secs in (0.0, 43200.0, 9.1e6):
        tsae32 = np.float32(secs) / np.float32(365.25 * 86400.0)
        jr = jastro.diurnal_solar(jastro.Orbit(), jnp.asarray(c["lat"]),
                                  jnp.asarray(c["lon"]), jnp.asarray(np.float32(1.0)),
                                  jnp.asarray(tsae32), 0.0436)
        tr = tastro.diurnal_solar(tastro.Orbit(), T(c["lat"]), T(c["lon"]),
                                  torch.tensor(1.0, dtype=torch.float32),
                                  torch.tensor(tsae32), 0.0436)
        for a, b in zip(tr, jr):
            close(a, b, rtol=1e-6, atol=1e-14)


# ---------------------------------------------------------------------------
# two_stream_gray
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["frierson", "byrne", "geen", "schneider"])
@pytest.mark.parametrize("seasonal", [False, True])
def test_two_stream_gray_matches(scheme, seasonal):
    c = columns(6)
    kw = dict(rad_scheme=scheme, do_seasonal=seasonal, use_time_average_coszen=seasonal,
              atm_abs=0.2)
    j = jtsg.TwoStreamGray(jtsg.TwoStreamConfig(**kw))
    t = ttsg.TwoStreamGray(ttsg.TwoStreamConfig(**kw))
    albedo = np.full(c["lat"].shape, 0.3)
    args = ("lat", "lon", "p_half", "t", "q")
    jd = j.down(*(jnp.asarray(c[k]) for k in args), jnp.asarray(albedo), gmt=1.3,
                time_since_ae=2.2, dt_rad_avg=0.05, carbon_conc=400.0)
    td = t.down(*(T(c[k]) for k in args), T(albedo), gmt=1.3, time_since_ae=2.2,
                dt_rad_avg=0.05, carbon_conc=400.0)
    for name in jd._fields:
        close(getattr(td, name), getattr(jd, name), atol=1e-12, msg=name)
    ju = j.up(jd, jnp.asarray(c["p_half"]), jnp.asarray(c["t_surf"]), jnp.asarray(albedo))
    tu = t.up(td, T(c["p_half"]), T(c["t_surf"]), T(albedo))
    for name in ju._fields:
        # heating rates are flux differences over thin layers: absolute
        # tolerance at 1e-12 of the fluxes' scale
        close(getattr(tu, name), getattr(ju, name), rtol=1e-10, atol=1e-12, msg=name)
