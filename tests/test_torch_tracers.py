"""Tracers and initial conditions: isca_tpu_torch against isca_tpu.

Same inputs, made from a numpy seed, go through isca_tpu's function and the
port's, on the CPU at T21:

* water_borrowing with holes, float64, rtol 1e-13;
* a_grid_horiz_advection on random fields, solid-body zonal flow, flow
  across the pole and Courant numbers above 1 (the integer-CFL path),
  float64 rtol 1e-12 of the tendency's largest entry; at float32 the
  gathers equal isca_tpu's one-hot products bit for bit, and the tendency
  agrees with isca_tpu's to 1e-5 of its largest entry (see that test);
* a 10-step primitive run with a grid tracer (FINITE_VOLUME_PARABOLIC), a
  spectral tracer with hole filling, the water fixer and the virtual
  temperature, at one and two dycore substeps, float64, rtol 1e-9 of each
  field's largest entry (the same arithmetic; 10 steps amplify last-bit
  differences to ~1e-12);
* the initial_conditions states and apply_* functions, rtol 1e-12;
* the damping driver (Rayleigh sponge with its heating, constant drag),
  rtol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore import fv_advection as jfv
from isca_tpu.dycore import initial_conditions as jic
from isca_tpu.dycore import primitive as jp
from isca_tpu.dycore.water_borrowing import water_borrowing as j_water_borrowing
from isca_tpu.physics import damping_driver as jdd
from isca_tpu.physics import gravity_wave_drag as jgwd
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch.dycore import fv_advection as tfv
from isca_tpu_torch.dycore import initial_conditions as tic
from isca_tpu_torch.dycore import primitive as tp
from isca_tpu_torch.dycore.water_borrowing import water_borrowing as t_water_borrowing
from isca_tpu_torch.physics import damping_driver as tdd
from isca_tpu_torch.physics import gravity_wave_drag as tgwd
from isca_tpu_torch.spectral import transforms as ttr
from isca_tpu_torch.utils.input_files import read_netcdf
from isca_tpu_torch.utils.tree import flatten_with_paths

L = 8


def close(got, ref, rtol, msg=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=msg)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's eager T21 steps are many small ops: one intra-op thread
    runs them faster than many, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def transforms():
    return (jtr.make_transforms("T21", dtype=jnp.float64),
            ttr.make_transforms("T21", dtype=torch.float64, device="cpu"))


# ---------------------------------------------------------------------------
# water_borrowing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2])
def test_water_borrowing_matches(passes):
    rng = np.random.default_rng(11)
    q = rng.uniform(0.0, 1e-3, (L, 6, 10))
    holes = rng.uniform(0, 1, q.shape) < 0.15
    q[holes] = -rng.uniform(0.0, 2e-4, holes.sum())
    q[3, 2, :] = -1e-5                      # a row of holes: donors are holes too
    dq = rng.normal(0.0, 1e-8, q.shape)
    p_half = np.cumsum(rng.uniform(500.0, 20000.0, (L + 1, 6, 10)), axis=0)
    ref = j_water_borrowing(jnp.asarray(dq), jnp.asarray(q), jnp.asarray(p_half), 1200.0,
                            passes=passes)
    got = t_water_borrowing(torch.as_tensor(dq), torch.as_tensor(q), torch.as_tensor(p_half),
                            1200.0, passes=passes)
    assert not np.allclose(np.asarray(ref), dq)    # the holes were filled
    close(got, ref, 1e-13)


# ---------------------------------------------------------------------------
# fv_advection
# ---------------------------------------------------------------------------

def test_fv_geometry_matches(transforms):
    jT, tT = transforms
    jg, tg = jfv.make_fv_geometry(jT), tfv.make_fv_geometry(tT)
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if torch.is_tensor(b):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)
        else:
            assert a == b, f.name


def advection_case(name, T, rng):
    """(u, v, q, dt) on the grid, level-first with L levels."""
    lat = np.asarray(T.lats)[None, :, None]
    lon = np.asarray(T.lons)[None, None, :]
    shape = (L,) + T.grid_shape
    q = rng.uniform(0.0, 1.0, shape) + np.exp(-((lat - 0.3) ** 2 + (lon - 1.5) ** 2) / 0.1)
    dt = 1800.0
    if name == "random":
        u, v = rng.normal(0.0, 20.0, shape), rng.normal(0.0, 10.0, shape)
    elif name == "solid_body":
        u = 40.0 * np.cos(lat) * np.ones(shape)
        v = np.zeros(shape)
    elif name == "cross_polar":
        # uniform flow across the north pole (along the 0/180 meridian)
        u = -25.0 * np.sin(lon) * np.sin(lat) * np.ones(shape)
        v = 25.0 * np.cos(lon) * np.ones(shape)
    else:   # integer_cfl: Courant numbers up to ~4 near the poles
        u = 80.0 * np.ones(shape) * (1.0 + rng.uniform(-0.2, 0.2, shape))
        u[: L // 2] *= -1.0
        v = 30.0 * np.cos(lon) * np.ones(shape)
        dt = 3600.0
    return u, v, q, dt


@pytest.mark.parametrize("case", ["random", "solid_body", "cross_polar", "integer_cfl"])
def test_a_grid_horiz_advection_float64(transforms, case):
    jT, tT = transforms
    u, v, q, dt = advection_case(case, jT, np.random.default_rng(5))
    jg, tg = jfv.make_fv_geometry(jT), tfv.make_fv_geometry(tT)
    if case == "integer_cfl":
        b = np.abs(u) * dt / (tg.dx * np.asarray(jg.c)[:, None])
        assert b.max() > 3.0       # the integer part of the flux is exercised
    for flux_form in (False, True):
        ref = jfv.a_grid_horiz_advection(jg, jnp.asarray(u), jnp.asarray(v), jnp.asarray(q),
                                         dt, flux_form=flux_form)
        got = tfv.a_grid_horiz_advection(tg, torch.as_tensor(u), torch.as_tensor(v),
                                         torch.as_tensor(q), dt, flux_form=flux_form)
        close(got, ref, 1e-12, f"{case} flux_form={flux_form}")
    # the non-monotone limiter
    jgn = dataclasses.replace(jg, monotone=False)
    tgn = dataclasses.replace(tg, monotone=False)
    close(tfv.a_grid_horiz_advection(tgn, *(torch.as_tensor(x) for x in (u, v, q)), dt),
          jfv.a_grid_horiz_advection(jgn, *(jnp.asarray(x) for x in (u, v, q)), dt),
          1e-12, f"{case} monotone=False")


def test_gather_matches_one_hot_bitwise():
    """The port's torch.gather selects the same float32 values, bit for bit,
    as isca_tpu's one-hot product at HIGHEST precision."""
    assert not jfv._FORCE_NATIVE_GATHER
    rng = np.random.default_rng(8)
    arrs = [rng.normal(0.0, 1.0, (L, 5, 64)).astype(np.float32) for _ in range(2)]
    idx = rng.integers(0, 64, (L, 5, 64))
    ref = jax.jit(jfv._gather_x_multi)([jnp.asarray(a) for a in arrs],
                                       jnp.asarray(idx, jnp.int32))
    for a, r in zip(arrs, ref):
        got = tfv._gather_x(torch.as_tensor(a), torch.as_tensor(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", ["random", "integer_cfl"])
def test_a_grid_horiz_advection_float32_one_hot(case):
    """The port at float32 against isca_tpu's float32 one-hot gather path,
    within 1e-5 of the tendency's largest entry. The gathers agree bit for
    bit (above); the rest is float32 rounding of the flux differences, whose
    order XLA's fusion changes: isca_tpu's own eager and jitted float32
    tendencies differ by up to 3.3e-6 of the largest entry here, and float32
    and float64 by 1.2e-3 to 5.2e-3 (the integer-CFL prefix sums cancel)."""
    assert not jfv._FORCE_NATIVE_GATHER
    jT = jtr.make_transforms("T21", dtype=jnp.float32)
    tT = ttr.make_transforms("T21", dtype=torch.float32, device="cpu")
    u, v, q, dt = advection_case(case, jT, np.random.default_rng(6))
    f32 = lambda x: x.astype(np.float32)
    ref = jax.jit(lambda *a: jfv.a_grid_horiz_advection(jfv.make_fv_geometry(jT), *a, dt))(
        *(jnp.asarray(f32(x)) for x in (u, v, q)))
    got = tfv.a_grid_horiz_advection(tfv.make_fv_geometry(tT),
                                     *(torch.as_tensor(f32(x)) for x in (u, v, q)), dt)
    assert got.dtype == torch.float32
    close(got, ref, 1e-5, case)


# ---------------------------------------------------------------------------
# primitive core with tracers
# ---------------------------------------------------------------------------

CORE = dict(resolution="T21", num_levels=L, dt=1200.0, do_water_correction=True,
            water_correction_limit=200.0e2, use_virtual_temperature=True)


def tracer_attrs(mod):
    va = "second_centered"
    return (mod.TracerAttr("sphum"),
            mod.TracerAttr("tsp", representation="spectral", vert_scheme=va,
                           robert_coeff=0.03, hole_filling=True))


def tracer_state(jcore, tcore, rng):
    """Cold start with moist, partly negative tracers from a seed, as the
    same numbers in both packages' states."""
    js, ts = jcore.cold_start(), tcore.cold_start()
    shape = (L,) + jcore.T.grid_shape
    q = rng.uniform(0.0, 1.5e-2, shape) * np.linspace(0.05, 1.0, L)[:, None, None]
    x = rng.normal(0.0, 1.0, shape)
    xs = np.asarray(jtr.grid_to_spec(jcore.T, jnp.asarray(x)))
    xg = np.asarray(jtr.spec_to_grid(jcore.T, jnp.asarray(xs)))
    for name, g in (("sphum", q), ("tsp", xg)):
        js.tracers[name] = jp.TwoLevel(jnp.asarray(g), jnp.asarray(g))
        tg = torch.as_tensor(g.copy())
        ts.tracers[name] = tp.TwoLevel(tg, tg)
    js.spec_tracers["tsp"] = jp.TwoLevel(jnp.asarray(xs), jnp.asarray(xs))
    xt = torch.as_tensor(xs.copy())
    ts.spec_tracers["tsp"] = tp.TwoLevel(xt, xt)
    return js, ts


@pytest.mark.parametrize("num_steps", [1, 2])
def test_ten_steps_with_tracers_match_isca_tpu(num_steps):
    attrs_j, attrs_t = tracer_attrs(jp), tracer_attrs(tp)
    jcore = jp.PrimitiveCore(jp.PrimitiveConfig(dtype=jnp.float64, num_steps=num_steps,
                                                **CORE), attrs_j)
    tcore = tp.PrimitiveCore(tp.PrimitiveConfig(dtype=torch.float64, num_steps=num_steps,
                                                **CORE), attrs_t, device="cpu")
    rng = np.random.default_rng(21)
    js, ts = tracer_state(jcore, tcore, rng)
    shape = (L,) + jcore.T.grid_shape
    du, dt_ = rng.normal(0.0, 1e-4, shape), rng.normal(0.0, 1e-4, shape)
    dq = rng.normal(0.0, 1e-8, shape)
    jt = jp.GridTendencies(du=jnp.asarray(du), dt=jnp.asarray(dt_),
                           dtracers={"sphum": jnp.asarray(dq)})
    tt = tp.GridTendencies(du=torch.as_tensor(du), dt=torch.as_tensor(dt_),
                           dtracers={"sphum": torch.as_tensor(dq)})
    zj, zt = jnp.zeros(jcore.T.grid_shape), torch.zeros(tcore.T.grid_shape, dtype=torch.float64)
    step = jax.jit(lambda s, first: jcore.dynamics_step(s, jt, zj, first=first),
                   static_argnums=1)
    for i in range(10):
        js = step(js, i == 0)
        ts = tcore.dynamics_step(ts, tt, zt, first=i == 0)
    jflat = dict(jax.tree_util.tree_flatten_with_path(js)[0])
    jflat = {jax.tree_util.keystr(k): v for k, v in jflat.items()}
    tflat = dict(flatten_with_paths(ts))
    assert set(tflat) == set(jflat)
    assert {".tracers['sphum'].curr", ".spec_tracers['tsp'].prev"} <= set(tflat)
    for k, v in jflat.items():
        close(tflat[k], v, 1e-9, k)
    # the diagnostics with the tracer fluxes and the virtual temperature
    jd = jcore.spectral_diagnostics(js, use_virtual_temperature=True)
    td = tcore.spectral_diagnostics(ts, use_virtual_temperature=True)
    assert set(td) == set(jd) and {"sphum", "vcomp_tsp"} <= set(td)
    for k in jd:
        close(td[k], jd[k], 1e-9, k)


def test_water_fixer_needs_sphum():
    with pytest.raises(ValueError, match="sphum"):
        tp.PrimitiveCore(tp.PrimitiveConfig(dtype=torch.float64, **CORE), device="cpu")


# ---------------------------------------------------------------------------
# initial conditions
# ---------------------------------------------------------------------------

# a zonal jet has no divergence and no meridional wind: those fields are
# rounding noise, held to the scale of their partner of the same units
PARTNER = {".divs.": ".vors.", ".divg.": ".vorg.", ".vg.": ".ug."}


def state_close(tstate, jstate, rtol=1e-12):
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    tflat = dict(flatten_with_paths(tstate))
    assert set(tflat) == set(jflat)
    for k, v in jflat.items():
        partner = next((k.replace(a, b) for a, b in PARTNER.items() if k.startswith(a)), k)
        scale = max(float(np.abs(v).max(initial=0.0)), float(np.abs(jflat[partner]).max()))
        got = tflat[k].numpy()
        assert got.shape == v.shape, k
        np.testing.assert_allclose(got, v, rtol=rtol, atol=rtol * scale, err_msg=k)


def cores(**kw):
    kw = {**dict(resolution="T21", num_levels=L), **kw}
    return (jp.PrimitiveCore(jp.PrimitiveConfig(dtype=jnp.float64, **kw)),
            tp.PrimitiveCore(tp.PrimitiveConfig(dtype=torch.float64, **kw), device="cpu"))


@pytest.mark.parametrize("case", ["jablonowski_2006", "polvani_2007_LC1",
                                  "polvani_2007_LC2", "polvani_2004"])
def test_initial_conditions_match(case):
    if case == "jablonowski_2006":
        jc, tc = cores()
        jout = jic.apply_jablonowski_2006(jc)
        tout = tic.apply_jablonowski_2006(tc)
    elif case.startswith("polvani_2007"):
        pk, bk = tic.polvani_2007_vert_coord(L)
        jpk, jbk = jic.polvani_2007_vert_coord(L)
        np.testing.assert_array_equal(bk, jbk)
        jc, tc = cores(vert_coord_option="input",
                       vert_coord_kwargs=(("pk", tuple(pk)), ("bk", tuple(bk))))
        init = case.rsplit("_", 1)[1]
        jout = jic.apply_polvani_2007(jc, jic.Polvani2007Config(type_of_init=init))
        tout = tic.apply_polvani_2007(tc, tic.Polvani2007Config(type_of_init=init))
    else:
        jc, tc = cores()
        jout = jic.apply_polvani_2004(jc)
        tout = tic.apply_polvani_2004(tc)
    state_close(tout[0], jout[0])
    close(tout[1], jout[1], 1e-12, "surf_geopotential")
    assert tout[0].ug.prev is tout[0].ug.curr       # one tensor at both levels


def test_external_file_matches(tmp_path):
    from scipy.io import netcdf_file

    jc0, _ = cores()
    attrs_j, attrs_t = tracer_attrs(jp), tracer_attrs(tp)
    jc = jp.PrimitiveCore(jc0.config, attrs_j)
    tc = tp.PrimitiveCore(tp.PrimitiveConfig(dtype=torch.float64, resolution="T21",
                                             num_levels=L), attrs_t, device="cpu")
    rng = np.random.default_rng(9)
    nlat, nlon = jc.T.grid_shape
    fields = {"u": rng.normal(0, 10, (L, nlat, nlon)),
              "v": rng.normal(0, 5, (nlon, nlat, L)),      # Fortran order
              "t": 250.0 + rng.normal(0, 5, (L, nlat, nlon)),
              "ps": 1e5 + rng.normal(0, 500, (nlon, nlat)),
              "sphum": rng.uniform(0, 1e-2, (L, nlat, nlon)),
              "tsp": rng.normal(0, 1, (L, nlat, nlon))}
    path = str(tmp_path / "ic.nc")
    with netcdf_file(path, "w") as nc:
        for n, size in (("a", L), ("b", nlat), ("c", nlon)):
            nc.createDimension(n, size)
        for k, a in fields.items():
            dims = {(L, nlat, nlon): ("a", "b", "c"), (nlon, nlat, L): ("c", "b", "a"),
                    (nlon, nlat): ("c", "b")}[a.shape]
            nc.createVariable(k, "d", dims)[:] = a
    assert set(read_netcdf(path)) == set(fields)
    zs = rng.normal(0, 100, (nlat, nlon))
    jout = jic.apply_external_file(jc, path, surf_geopotential=zs)
    tout = tic.apply_external_file(tc, path, surf_geopotential=zs)
    state_close(tout[0], jout[0])
    close(tout[1], jout[1], 1e-12)
    with pytest.raises(ValueError, match="does not exist"):
        tic.apply_external_file(tc, path, u_name="uu")


def test_read_netcdf4_without_h5py_names_it(tmp_path, monkeypatch):
    path = tmp_path / "hdf5.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        read_netcdf(str(path))


# ---------------------------------------------------------------------------
# damping driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("options", [
    dict(),                                              # the Frierson sponge
    dict(do_conserve_energy=False, trayfric=3600.0),
    dict(do_rayleigh=False, do_const_drag=True, const_drag_off=0.3),
])
def test_damping_driver_matches(options):
    kw = {**dict(trayfric=-0.25, sponge_pbottom=5000.0), **options}
    rng = np.random.default_rng(4)
    shape = (3, 5, L)
    p_full = np.sort(rng.uniform(50.0, 1e5, shape), axis=-1)
    u, v = rng.normal(0, 30, shape), rng.normal(0, 10, shape)
    dts = [rng.normal(0, 1e-4, shape) for _ in range(3)]
    lat2d = np.deg2rad(rng.uniform(-80, 80, shape[:-1]))
    day = np.float32(123.4)
    ref = jdd.damping_driver(jdd.DampingDriverConfig(**kw), 1440.0, jnp.asarray(p_full),
                             jnp.asarray(u), jnp.asarray(v), *(jnp.asarray(x) for x in dts),
                             lat2d=jnp.asarray(lat2d), day_of_year=jnp.asarray(day),
                             days_per_year=365.25)
    got = tdd.damping_driver(tdd.DampingDriverConfig(**kw), 1440.0, torch.as_tensor(p_full),
                             torch.as_tensor(u), torch.as_tensor(v),
                             *(torch.as_tensor(x) for x in dts),
                             lat2d=torch.as_tensor(lat2d), day_of_year=torch.as_tensor(day),
                             days_per_year=365.25)
    for name in ("dt_u", "dt_v", "dt_t"):
        close(getattr(got, name), getattr(ref, name), 1e-12, name)
    assert set(got.diagnostics) == set(ref.diagnostics) and got.diagnostics
    for k in ref.diagnostics:
        close(got.diagnostics[k], ref.diagnostics[k], 1e-12, k)


@pytest.mark.parametrize("name", ["do_topo_drag"])
def test_unported_drags_raise(name):
    x = torch.zeros(2, L, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tdd.damping_driver(tdd.DampingDriverConfig(**{name: True}), 1.0, x, x, x, x, x, x)


def test_drag_configs_mirror_isca_tpu():
    for jcls, tcls in ((jdd.DampingDriverConfig, tdd.DampingDriverConfig),
                       (jgwd.MgDragConfig, tgwd.MgDragConfig),
                       (jgwd.CgDragConfig, tgwd.CgDragConfig),
                       (jp.TracerAttr, tp.TracerAttr)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert list(tf) == list(jf), tcls
        for k in jf:
            if k not in ("constants", "mg", "cg"):
                assert tf[k] == jf[k], (tcls, k)
