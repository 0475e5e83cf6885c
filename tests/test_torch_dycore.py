"""isca_tpu_torch's dycore modules against isca_tpu's: damping,
vert_advection (every scheme), build_implicit/implicit_correction, the
Held-Suarez forcing (every option), cold_start and single dynamics steps.

Inputs are made with numpy from a seed (or by isca_tpu itself) and go
through both packages at float64 on the CPU, at T21 with 8 levels; a model
state travels between the packages through isca_tpu_torch.convert.

Tolerances: tables built by the same numpy code are equal bit for bit.
Elementwise arithmetic agrees to rtol 1e-12 of each entry; where results are
differences of nearly equal terms (flux divergences, matrix inverses,
contractions that sum in another order than XLA), to 1e-12 of the largest
entry of the compared array. A whole dynamics step (transforms, implicit
solve, fixers) is held to rtol 1e-10 of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore import damping as jdamp
from isca_tpu.dycore import implicit as jimp
from isca_tpu.dycore import press_geopot as jpg
from isca_tpu.dycore import vert_advection as jva
from isca_tpu.dycore import vert_coordinate as jvc
from isca_tpu.dycore.primitive import GridTendencies as JGT
from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.dycore.primitive import PrimitiveCore as JCore
from isca_tpu.dycore.primitive import PrimitiveState as JState
from isca_tpu.dycore.time_integration import TwoLevel as JTwo
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.physics import hs_forcing as jhs
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch.convert import (PRIMITIVE_STATE_KEYS, PRIMITIVE_TWO_LEVEL,
                                    primitive_state_from_numpy, primitive_state_to_numpy)
from isca_tpu_torch.dycore import damping as tdamp
from isca_tpu_torch.dycore import implicit as timp
from isca_tpu_torch.dycore import vert_advection as tva
from isca_tpu_torch.dycore.primitive import GridTendencies as TGT
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.dycore.primitive import PrimitiveCore as TCore
from isca_tpu_torch.dycore.time_integration import TwoLevel as TTwo
from isca_tpu_torch.physics import hs_forcing as ths
from isca_tpu_torch.spectral import transforms as ttr

RTOL = 1e-12
STEP_RTOL = 1e-10
SHAPE = dict(resolution="T21", num_levels=8, dt=1200.0)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=RTOL, scaled=True, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    atol = rtol * float(np.abs(ref).max()) if scaled and ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


_TRANSFORMS = {}


def transforms():
    if not _TRANSFORMS:
        _TRANSFORMS["j"] = jtr.make_transforms("T21", dtype=jnp.float64)
        _TRANSFORMS["t"] = ttr.make_transforms("T21", dtype=torch.float64, device="cpu")
    return _TRANSFORMS["j"], _TRANSFORMS["t"]


def random_spec(jT, seed, nlev=8):
    rng = np.random.default_rng(seed)
    shape = (nlev, jT.num_fourier + 1, jT.num_spherical + 1)
    s = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    s[..., 0, :] = s[..., 0, :].real
    return s * np.asarray(jT.triangle)


# ---------------------------------------------------------------------------
# damping
# ---------------------------------------------------------------------------

DAMPING_CASES = {
    "resolution_dependent": dict(),
    "resolution_independent": dict(damping_option="resolution_independent",
                                   damping_coeff=1e-30, damping_order=3),
    "exponential_cutoff": dict(damping_option="exponential_cutoff", cutoff_wn=10,
                               damping_order=4),
    "drag_and_sponges": dict(damping_coeff_r=1e-7, eddy_sponge_coeff=3e6,
                             zmu_sponge_coeff=1e6, zmv_sponge_coeff=2e6),
}


@pytest.mark.parametrize("case", list(DAMPING_CASES))
def test_damping_matches(case):
    jT, tT = transforms()
    kw = DAMPING_CASES[case]
    jD, tD = jdamp.make_damping(jT, **kw), tdamp.make_damping(tT, **kw)
    for k in ("rate", "sponge_vor", "sponge_div"):
        np.testing.assert_array_equal(getattr(tD, k).numpy(), np.asarray(getattr(jD, k)))
    for k in ("exponential", "coeff", "has_sponge"):
        assert getattr(tD, k) == getattr(jD, k), k
    x, tend = random_spec(jT, 1), random_spec(jT, 2)
    for dt in (1200.0, 2400.0):
        close(tdamp.apply_damping(tD, T(x), T(tend), dt),
              jdamp.apply_damping(jD, jnp.asarray(x), jnp.asarray(tend), dt), scaled=False)
        for field in ("vor", "div"):
            t_in = T(tend)
            out = tdamp.apply_top_sponge(tD, T(x), t_in, dt, field)
            close(out, jdamp.apply_top_sponge(jD, jnp.asarray(x), jnp.asarray(tend), dt, field),
                  scaled=False)
            np.testing.assert_array_equal(t_in.numpy(), tend)   # input not written


def test_invalid_damping_option_raises():
    with pytest.raises(ValueError, match="damping_option"):
        tdamp.make_damping(transforms()[1], damping_option="bogus")


# ---------------------------------------------------------------------------
# vert_advection
# ---------------------------------------------------------------------------

SCHEMES = [jva.SECOND_CENTERED, jva.SECOND_CENTERED_WTS, jva.FOURTH_CENTERED,
           jva.FOURTH_CENTERED_WTS, jva.VAN_LEER_LINEAR, jva.FINITE_VOLUME_PARABOLIC]


@pytest.mark.parametrize("form", ["advective", "flux"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_vert_advection_matches(scheme, form):
    rng = np.random.default_rng(3)
    shape, L = (3, 5), 8
    _, bk = jvc.uneven_sigma(L, 6.0, 0.5, 7.5)
    ps = 1e5 + rng.uniform(-3e3, 3e3, shape)
    dp = np.diff(bk * ps[..., None], axis=-1)
    w = rng.normal(0.0, 5e-2, shape + (L + 1,)) * ps[..., None] / 1e3
    w[..., 0] = w[..., -1] = 0.0
    # a profile with extrema and sign changes of its slope, so every limiter branch runs
    r = 250.0 + 20.0 * np.sin(np.arange(L) * 1.3) + rng.normal(0.0, 3.0, shape + (L,))
    ref = jva.vert_advection(900.0, jnp.asarray(w), jnp.asarray(dp), jnp.asarray(r), scheme, form)
    out = tva.vert_advection(900.0, T(w), T(dp), T(r), scheme, form)
    # flux divergences cancel: 1e-12 of the largest tendency
    close(out, ref)


def test_vert_advection_unknown_scheme_raises():
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unknown"):
        tva.vert_advection(1.0, torch.zeros(2, 5), z + 1.0, z, "upwind")


# ---------------------------------------------------------------------------
# implicit
# ---------------------------------------------------------------------------

IMPLICIT_CASES = {
    "even_sigma": ("even_sigma", {}, "simmons_and_burridge"),
    "uneven_sigma": ("uneven_sigma", dict(scale_heights=6.0, surf_res=0.5, exponent=7.5),
                     "simmons_and_burridge"),
    "hybrid": ("hybrid", {}, "simmons_and_burridge"),
    "mcm": ("even_sigma", {}, "mcm"),
}


def implicit_pair(case, dts=(1200.0, 2400.0)):
    option, kw, diff = IMPLICIT_CASES[case]
    pk, bk = jvc.compute_vert_coord(option, 8, **kw)
    jT, _ = transforms()
    args = dict(num_spherical=jT.num_spherical, radius=6371.0e3, delta_ts=dts,
                t_ref=300.0, vert_difference_option=diff)
    return (jimp.build_implicit(pk, bk, dtype=jnp.float64, **args),
            timp.build_implicit(pk, bk, dtype=torch.float64, **args))


@pytest.mark.parametrize("case", list(IMPLICIT_CASES))
def test_build_implicit_matches(case):
    ji, ti = implicit_pair(case)
    assert ti.dts == ji.dts and ti.ps_ref == ji.ps_ref and ti.alpha == ji.alpha
    # same float64 arithmetic on one column; h2 is a finite difference in
    # ln p and the wave matrices are inverses, so they are held to 1e-12 of
    # their largest entry
    for k in ("nu", "DT", "GG", "h", "lam_n", "wave_matrices"):
        close(getattr(ti, k), getattr(ji, k), msg=k)


@pytest.mark.parametrize("case", list(IMPLICIT_CASES))
def test_implicit_correction_matches(case):
    ji, ti = implicit_pair(case)
    jT, _ = transforms()
    sp = [random_spec(jT, 10 + i) for i in range(7)]
    lnps = [random_spec(jT, 20 + i, nlev=1)[0] for i in range(3)]
    for dt in ji.dts:
        jout = jimp.implicit_correction(
            ji, jnp.asarray(sp[0]), jnp.asarray(sp[1]), jnp.asarray(lnps[0]),
            JTwo(jnp.asarray(sp[2]), jnp.asarray(sp[3])),
            JTwo(jnp.asarray(sp[4]), jnp.asarray(sp[5])),
            JTwo(jnp.asarray(lnps[1]), jnp.asarray(lnps[2])), dt)
        tout = timp.implicit_correction(
            ti, T(sp[0]), T(sp[1]), T(lnps[0]), TTwo(T(sp[2]), T(sp[3])),
            TTwo(T(sp[4]), T(sp[5])), TTwo(T(lnps[1]), T(lnps[2])), dt)
        for a, b, name in zip(tout, jout, ("dt_divs", "dt_ts", "dt_lnps")):
            close(a, b, msg=f"{name} dt={dt}")
    with pytest.raises(ValueError):
        timp.implicit_correction(ti, T(sp[0]), T(sp[1]), T(lnps[0]),
                                 TTwo(T(sp[2]), T(sp[3])), TTwo(T(sp[4]), T(sp[5])),
                                 TTwo(T(lnps[1]), T(lnps[2])), 600.0)


# ---------------------------------------------------------------------------
# hs_forcing
# ---------------------------------------------------------------------------

HS_CASES = {
    "Held_Suarez": dict(),
    "no_energy_conservation": dict(do_conserve_energy=False, eps=10.0),
    "exoplanet": dict(equilibrium_t_option="exoplanet"),
    "from_file": dict(equilibrium_t_option="from_file"),
    "relax_to_specified_wind": dict(relax_to_specified_wind=True),
    "local_heating": dict(local_heating_srfamp=2.0, local_heating_xcenter=90.0),
    "rates_in_seconds": dict(ka=3.0e6, ks=3.0e5, kf=0.0),
}


def hs_inputs(seed=4, L=8):
    jT, tT = transforms()
    rng = np.random.default_rng(seed)
    grid = (jT.nlat, jT.nlon)
    pk, bk = jvc.compute_vert_coord("even_sigma", L)
    psg = 1e5 + rng.uniform(-3e3, 3e3, grid)
    ph, _, pf, _ = jpg.pressure_variables(np, pk, bk, psg, True)
    lev_first = lambda a: np.moveaxis(a, -1, 0)
    return dict(u=rng.normal(0, 10, (L,) + grid), v=rng.normal(0, 5, (L,) + grid),
                t=rng.uniform(200, 310, (L,) + grid), p_full=lev_first(pf),
                p_half=lev_first(ph), psg=psg,
                coszen=np.clip(rng.uniform(-0.5, 1.0, grid), 0.0, None),
                teq=rng.uniform(200, 300, (L, jT.nlat, 1)),
                u_spec=rng.normal(0, 20, (L, jT.nlat, 1)),
                v_spec=rng.normal(0, 1, (L, jT.nlat, 1)),
                r=rng.uniform(0, 1e-3, (L,) + grid))


@pytest.mark.parametrize("case", list(HS_CASES))
def test_hs_forcing_matches(case):
    jT, tT = transforms()
    kw = HS_CASES[case]
    jf = jhs.HSForcing(jhs.HSForcingConfig(**kw), jT.lats)
    tf = ths.HSForcing(ths.HSForcingConfig(**kw), tT.lats)
    d = hs_inputs()
    for f, conv in ((jf, jnp.asarray), (tf, T)):
        f.teq_field = conv(d["teq"])
        f.u_spec, f.v_spec = conv(d["u_spec"]), conv(d["v_spec"])
    names = ("u", "v", "t", "p_full", "psg")
    coszen = d["coszen"] if case == "exoplanet" else None
    jout = jf(*(jnp.asarray(d[k]) for k in names),
              coszen=None if coszen is None else jnp.asarray(coszen))
    tout = tf(*(T(d[k]) for k in names), coszen=None if coszen is None else T(coszen))
    for k in ("du", "dv", "dt"):
        close(getattr(tout, k), getattr(jout, k), msg=k)
    assert tout.dtracers is None
    close(tf.tracer_source_sink(T(d["r"]), T(d["p_half"])),
          jf.tracer_source_sink(jnp.asarray(d["r"]), jnp.asarray(d["p_half"])))


# ---------------------------------------------------------------------------
# cold_start and dynamics_step
# ---------------------------------------------------------------------------

CORE_CASES = {
    "default": dict(),
    "num_steps_2": dict(num_steps=2),
    "mcm": dict(vert_difference_option="mcm"),
    "sponges_and_split_damping": dict(eddy_sponge_coeff=2e5, zmu_sponge_coeff=1e5,
                                      zmv_sponge_coeff=1e5, damping_order_vor=3,
                                      damping_coeff_div=2e-4, raw_filter_coeff=0.53),
    "prev_level_schemes": dict(uv_vert_advect_scheme=jva.FOURTH_CENTERED,
                               t_vert_advect_scheme=jva.VAN_LEER_LINEAR,
                               vert_coord_option="uneven_sigma",
                               vert_coord_kwargs=(("scale_heights", 6.0),
                                                  ("surf_res", 0.5), ("exponent", 7.5))),
    "symmetric_fft_no_fixers": dict(make_symmetric=True, fourier_method="fft",
                                    do_mass_correction=False, do_energy_correction=False),
    "exponential_damping_no_implicit": dict(damping_option="exponential_cutoff",
                                            damping_order=4, use_implicit=False, dt=300.0),
}


def cores(case):
    kw = {**SHAPE, **CORE_CASES[case]}
    return (JCore(JPC(dtype=jnp.float64, **kw)),
            TCore(TPC(dtype=torch.float64, **kw), device="cpu"))


def jax_state_dict(s: JState) -> dict:
    d = {f"{n}_{lvl}": np.array(getattr(getattr(s, n), lvl))
         for n in PRIMITIVE_TWO_LEVEL for lvl in ("prev", "curr")}
    d["wg_full"] = np.array(s.wg_full)
    return d


def jax_state(d) -> JState:
    two = {n: JTwo(jnp.asarray(d[f"{n}_prev"]), jnp.asarray(d[f"{n}_curr"]))
           for n in PRIMITIVE_TWO_LEVEL}
    return JState(**two, tracers={}, spec_tracers={}, wg_full=jnp.asarray(d["wg_full"]))


# fields of one unit share a scale: a divergence that is zero up to rounding
# (cold start) is judged against the vorticity beside it
SCALE_GROUPS = (("vors", "divs"), ("vorg", "divg"), ("ug", "vg"))


def compare_states(t_state, j_state, rtol):
    """Every field to rtol of itself plus rtol of the largest entry of its
    scale group (both time levels)."""
    got = primitive_state_to_numpy(t_state)
    ref = jax_state_dict(j_state)
    assert set(got) == set(PRIMITIVE_STATE_KEYS)
    group = {n: g for g in SCALE_GROUPS for n in g}
    for k in PRIMITIVE_STATE_KEYS:
        assert got[k].dtype == ref[k].dtype, k
        name = k.rsplit("_", 1)[0] if k != "wg_full" else k
        peers = group.get(name, (name,))
        scale = max(float(np.abs(v).max()) for kk, v in ref.items()
                    if (kk.rsplit("_", 1)[0] if kk != "wg_full" else kk) in peers)
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=rtol * scale, err_msg=k)


_SPUN_UP = {}


def spun_up_state():
    """isca_tpu's HS state after 8 steps from cold start with a random
    temperature perturbation: both time levels differ and every field moves."""
    if not _SPUN_UP:
        model = JHSM(JHSC(core=JPC(dtype=jnp.float64, **SHAPE)))
        s = model.initial_state()
        jT = model.core.T
        dts = 0.5 * random_spec(jT, 30) * (np.arange(jT.num_spherical + 1) <= 8)
        ts = s.ts.curr + jnp.asarray(dts)
        tg = jtr.spec_to_grid(jT, ts)
        s = dataclasses.replace(s, ts=JTwo(ts, ts), tg=JTwo(tg, tg))
        _SPUN_UP["d"] = jax_state_dict(jax.jit(lambda x: model.run(x, 8, first=True))(s))
    return _SPUN_UP["d"]


def physics(d, seed=5):
    rng = np.random.default_rng(seed)
    shape = d["tg_curr"].shape
    return dict(du=rng.normal(0, 1e-5, shape), dv=rng.normal(0, 1e-5, shape),
                dt=rng.normal(0, 1e-5, shape))


@pytest.mark.parametrize("case", ["default", "prev_level_schemes", "mcm"])
def test_cold_start_matches(case):
    jc, tc = cores(case)
    compare_states(tc.cold_start(), jc.cold_start(), RTOL)
    rng = np.random.default_rng(6)
    phi = rng.uniform(0, 2e3, tc.T.grid_shape)
    compare_states(tc.cold_start(T(phi)), jc.cold_start(jnp.asarray(phi)), RTOL)
    np.testing.assert_array_equal(tc.static_diag_fields()["zsurf"].numpy(),
                                  np.asarray(jc.static_diag_fields()["zsurf"]))


@pytest.mark.parametrize("first", [True, False], ids=["first_step", "leapfrog_step"])
@pytest.mark.parametrize("case", list(CORE_CASES))
def test_dynamics_step_matches(case, first):
    jc, tc = cores(case)
    if first:
        d = jax_state_dict(jc.cold_start())
    else:
        d = spun_up_state()
    if case == "symmetric_fft_no_fixers":   # keep the state inside the symmetric model
        tri = np.asarray(jc.T.triangle)
        d = {k: (v * tri if v.dtype.kind == "c" else v) for k, v in d.items()}
    p = physics(d)
    surf = np.zeros(tc.T.grid_shape)
    jout = jc.dynamics_step(jax_state(d), JGT(**{k: jnp.asarray(v) for k, v in p.items()}),
                            jnp.asarray(surf), first=first)
    t_in = primitive_state_from_numpy(d, torch.float64, device="cpu")
    tout = tc.dynamics_step(t_in, TGT(**{k: T(v) for k, v in p.items()}), T(surf), first=first)
    compare_states(tout, jout, STEP_RTOL)
    # the input state is not written (cold_start's two levels share tensors)
    for k, v in primitive_state_to_numpy(t_in).items():
        np.testing.assert_array_equal(v, d[k], err_msg=k)


def test_cold_start_levels_share_and_step_keeps_them():
    """cold_start gives prev and curr one tensor (as isca_tpu does); a step
    must leave that tensor as it was."""
    _, tc = cores("default")
    s = tc.cold_start()
    assert s.lnps.prev is s.lnps.curr and s.ts.prev is s.ts.curr
    before = {k: v.copy() for k, v in primitive_state_to_numpy(s).items()}
    tc.dynamics_step(s, TGT(), tc.surf_geopotential, first=True)
    for k, v in primitive_state_to_numpy(s).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_unported_core_options_raise():
    base = TPC(dtype=torch.float64, **SHAPE)
    # tracers and the water fixer are ported (tests/test_torch_tracers.py);
    # the fixer still needs a sphum tracer to fix
    with pytest.raises(ValueError, match="sphum"):
        TCore(dataclasses.replace(base, do_water_correction=True), device="cpu")
    # the sharded core is ported (tests/test_torch_parallel.py); a mesh that
    # is not a parallel.mesh.Mesh still raises
    with pytest.raises(TypeError, match="Mesh"):
        TCore(dataclasses.replace(base, mesh=object()), device="cpu")
    # every transform precision is ported (tests/test_torch_precision.py);
    # a name jax.lax.Precision lacks raises
    assert TCore(dataclasses.replace(base, transform_precision="High"),
                 device="cpu").T.prec == "high"
    with pytest.raises(ValueError, match="precision"):
        TCore(dataclasses.replace(base, transform_precision="bf16"), device="cpu")
    # spectral_diagnostics is ported now (tests/test_torch_harness.py holds
    # it against isca_tpu); the options above still raise
    core = TCore(base, device="cpu")
    assert "slp" in core.spectral_diagnostics(core.cold_start())
