"""isca_tpu_torch's SimCloud and SPOOKIE cloud schemes (physics/cloud_simple.py)
against isca_tpu.

Inputs are made with numpy from a seed (3 x 5 columns, 14 levels, relative
humidity from 0.4 to 1.1 so that every formula meets clear, partly cloudy and
saturated layers; pressure velocity of both signs; a land mask) and go
through both packages at float64 on the CPU, every output and diagnostic at
rtol 1e-12 of each field's largest entry. One column is built so that the
marine-stratus level picks tie (two levels equally close to 700 hPa, two
equal inversion gradients): both packages take the first. The reference's
own checks (tests/test_cloud_simple.py) are mirrored on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.constants import EARTH
from isca_tpu.dycore import press_geopot as jpg
from isca_tpu.dycore import vert_coordinate as jvc
from isca_tpu.physics import cloud_simple as jcs
from isca_tpu.physics import sat_vapor_pres as jsvp
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import cloud_simple as tcs
from isca_tpu_torch.physics import sat_vapor_pres as tsvp
from tests.test_torch_socrates_gcm import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-12
FORMULAS = ("LINEAR", "SPOOKIE", "SUNDQVIST", "SMITH", "SLINGO", "XR96")
METHODS = ("PARK_ELF", "LTS", "SLINGO", "EIS_WOOD", "ECTEI")
LS_OPTIONS = {
    "default": dict(),
    "omega_freezedry": dict(do_adjust_cld_by_omega=True, do_freezedry=True),
    "fitted": dict(do_fitted_rhcrit=True),
    "poly": dict(do_poly_rhcrit=True),
}


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def close(port, ref, rtol=RTOL, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    # scaled by the largest finite entry: dthdp's surface layer divides by
    # p_half[-1] - psg = 0, as the reference does, and is infinite
    atol = rtol * float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


def close_dict(port, ref, msg=""):
    assert set(port) == set(ref), (msg, set(port) ^ set(ref))
    for k, b in ref.items():
        close(port[k], b, msg=f"{msg} {k}")


def svps():
    return jsvp.SatVaporPres(do_simple=True), tsvp.SatVaporPres(do_simple=True)


def cloud_columns(seed=0, shape=(3, 5), L=14):
    """Level-last columns for the cloud schemes: humid lapse-rate profiles
    with a low inversion, RH 0.4-1.1, omega of both signs, heights, a land
    mask. Column [0, 0] ties the marine-stratus level picks."""
    rng = np.random.default_rng(seed)
    _, bk = jvc.uneven_sigma(L, 6.0, 0.5, 7.5)
    ps = 1.0e5 + rng.uniform(-2e3, 2e3, shape)
    p_half, ln_ph, p_full, ln_pf = (np.array(a) for a in jpg.pressure_variables(
        np, np.zeros(L + 1), bk, ps, True))
    t = np.maximum(295.0 * (p_full / 1e5) ** 0.19, 200.0) + rng.uniform(-2, 2, shape + (L,))
    t += 8.0 * np.exp(-((p_full - 9.0e4) / 3.0e3) ** 2) * rng.uniform(0, 1, shape + (1,))
    # the tie column: two levels 1000 Pa either side of 700 hPa, and the
    # three lowest layers at 1000 hPa with equal steps in p_half and T, so
    # that theta = T and two inversion gradients are equal
    p_full[0, 0, 5:7] = (6.9e4, 7.1e4)
    p_full[0, 0, -3:] = 1.0e5
    p_half[0, 0, -4:] = (9.6e4, 9.8e4, 1.0e5, 1.02e5)
    t[0, 0, -3:] = (300.0, 296.0, 292.0)
    svp = jsvp.SatVaporPres(do_simple=True)
    rh = rng.uniform(0.4, 1.1, shape + (L,))
    rh[1, 1, :4] = 1.0
    rh[2, 2, :] = 0.0
    q = rh * np.asarray(svp.qs(J(t), J(p_full)))
    gf, _ = jpg.compute_geopotential(np, EARTH.rdgas, t, ln_ph, ln_pf, np.zeros(shape),
                                     True, p_half=p_half)
    return dict(p_half=p_half, p_full=p_full, t=t, q=q, rh=rh,
                z_full=np.asarray(gf) / EARTH.grav,
                wg=rng.uniform(-0.2, 0.2, shape + (L,)),
                ocean=rng.uniform(0, 1, shape) > 0.3,
                t_2m=t[..., -1] - rng.uniform(0, 2, shape),
                q_2m=q[..., -1] * 0.95, rh_2m=np.clip(rh[..., -1], 0.0, 1.0))


@pytest.mark.parametrize("option", list(LS_OPTIONS))
@pytest.mark.parametrize("formula", FORMULAS)
def test_large_scale_cloud_fraction_matches(formula, option):
    c = cloud_columns(1)
    jcfg = jcs.LargeScaleCloudConfig(formula=formula, **LS_OPTIONS[option])
    tcfg = tcs.LargeScaleCloudConfig(formula=formula, **LS_OPTIONS[option])
    qs = c["q"] / np.where(c["rh"] > 0, c["rh"], 1.0)
    qcl = np.full_like(c["t"], 1e-8)
    names = ("p_full", "ps", "rh", "q", "qs", "qcl", "wg")
    args = dict(c, ps=c["p_half"][..., -1], qs=qs, qcl=qcl)
    ref = jcs.large_scale_cloud_fraction(jcfg, *(J(args[k]) for k in names))
    out = tcs.large_scale_cloud_fraction(tcfg, *(T(args[k]) for k in names))
    for a, b, name in zip(out, ref, ("cf", "rhcrit")):
        close(a, b, msg=f"{formula} {option} {name}")
    cf = np.asarray(ref[0])
    assert (cf == 0.0).any() and (cf > 0.0).any()


@pytest.mark.parametrize("method", METHODS)
def test_marine_strat_cloud_matches(method):
    c = cloud_columns(2)
    cf0 = np.clip(c["rh"] - 0.6, 0.0, 1.0)
    names = ("t", "p_full", "p_half", "z_full", "rh", "q", "t_2m", "q_2m", "rh_2m",
             "ps", "wg", "ocean", "cf0")
    wg = np.abs(c["wg"])                       # subsiding everywhere
    args = dict(c, ps=c["p_half"][..., -1], cf0=cf0, wg=wg)
    jcfg = jcs.MarineStratConfig(method=method)
    tcfg = tcs.MarineStratConfig(method=method)
    ref_cf, ref_diag = jcs.marine_strat_cloud(jcfg, EARTH, *(J(args[k]) for k in names))
    out_cf, out_diag = tcs.marine_strat_cloud(tcfg, tcs.EARTH, *(T(args[k]) for k in names))
    close(out_cf, ref_cf, msg=method)
    close_dict(out_diag, ref_diag, msg=method)
    # the scheme acted somewhere, and in the tie column at the first of the
    # two equal gradients (layers -3, -2), not the second (-2, -1)
    strat = np.asarray(ref_diag["marine_strat"])
    if method in ("LTS", "PARK_ELF", "EIS_WOOD", "ECTEI"):
        assert (strat > 0).any()
    dthdp = np.asarray(ref_diag["dthdp"])[0, 0]
    assert dthdp[-3] == dthdp[-2] < jcfg.dthdp_min_threshold


@pytest.mark.parametrize("overlap", ["MAXIMUM-RANDOM", "MAXIMUM", "RANDOM"])
def test_cloud_cover_diags_matches(overlap):
    c = cloud_columns(3)
    cf = np.clip(c["rh"] - 0.75, 0.0, 1.0) * 2.5
    cf[0, 1, :] = 0.0                          # a clear column
    cf[0, 2, :] = np.where(np.arange(cf.shape[-1]) % 2, 0.3, 0.0)   # most regions
    ref = jcs.cloud_cover_diags(J(cf), J(c["p_full"]), J(c["p_half"]), overlap)
    out = tcs.cloud_cover_diags(T(cf), T(c["p_full"]), T(c["p_half"]), overlap)
    close_dict(out, ref, msg=overlap)


CS_CASES = {
    "default": dict(),
    "stratocumulus": dict(do_add_stratocumulus=True),
    "slingo_strat_xr96": dict(do_add_stratocumulus=True,
                              large_scale=dict(formula="XR96"),
                              marine_strat=dict(method="SLINGO")),
    "qcl_by_pressure": dict(do_qcl_with_temp=False, overlap_assumption="RANDOM"),
    "no_cover_diags": dict(do_cloud_cover_diags=False,
                           large_scale=dict(formula="SUNDQVIST",
                                            do_adjust_cld_by_omega=True)),
}


def cloud_simple_config(pkg, case):
    kw = dict(CS_CASES[case])
    if "large_scale" in kw:
        kw["large_scale"] = pkg.LargeScaleCloudConfig(**kw["large_scale"])
    if "marine_strat" in kw:
        kw["marine_strat"] = pkg.MarineStratConfig(**kw["marine_strat"])
    return pkg.CloudSimpleConfig(**kw)


@pytest.mark.parametrize("with_ocean", [False, True])
@pytest.mark.parametrize("case", list(CS_CASES))
def test_cloud_simple_matches(case, with_ocean):
    c = cloud_columns(4)
    jsv, tsv = svps()
    j = jcs.CloudSimple(cloud_simple_config(jcs, case), jsv)
    t = tcs.CloudSimple(cloud_simple_config(tcs, case), tsv)
    names = ("p_half", "p_full", "t", "q", "z_full", "wg")
    kw = lambda f: dict(ocean=f(c["ocean"])) if with_ocean else {}
    # isca_tpu op by op, not under jax.jit: at saturation (column [1, 1])
    # 1 - sqrt(1 - rh) turns the last bit of qs, which XLA's fused exp
    # rounds otherwise, into 1e-8 of cf
    ref = j(*(J(c[k]) for k in names), J(c["p_half"][..., -1]), **kw(J))
    out = t(*(T(c[k]) for k in names), T(c["p_half"][..., -1]), **kw(T))
    for name in ("cf", "reff_rad", "qcl_rad", "frac_liq"):
        close(getattr(out, name), getattr(ref, name), msg=f"{case} {name}")
    close_dict(out.diagnostics, ref.diagnostics, msg=case)
    cf = np.asarray(ref.cf)
    assert (cf == 0.0).any() and ((cf > 0.0) & (cf < 1.0)).any()


@pytest.mark.parametrize("protocol", [1, 2])
def test_cloud_spookie_matches(protocol):
    c = cloud_columns(5)
    jsv, tsv = svps()
    ref = jcs.cloud_spookie(jcs.CloudSpookieConfig(spookie_protocol=protocol), jsv,
                            J(c["p_full"]), J(c["t"]), J(c["q"]))
    out = tcs.cloud_spookie(tcs.CloudSpookieConfig(spookie_protocol=protocol), tsv,
                            T(c["p_full"]), T(c["t"]), T(c["q"]))
    for a, b, name in zip(out[:4], ref[:4], ("cf", "cca", "reff_rad", "qcl_rad")):
        close(a, b, msg=f"protocol {protocol} {name}")
    close_dict(out[4], ref[4], msg=f"protocol {protocol}")


def test_lcl_and_height_match():
    rng = np.random.default_rng(6)
    t, rh = rng.uniform(250, 305, 40), rng.uniform(0.0, 1.2, 40)
    close(tcs.lcl_height(T(t), T(rh), tcs.EARTH), jcs.lcl_height(J(t), J(rh), EARTH))
    z = rng.uniform(0, 3e4, 40)
    close(tcs.geopotential_to_height(T(z)), jcs.geopotential_to_height(J(z)))


# ---------------------------------------------------------------------------
# the reference's own checks (tests/test_cloud_simple.py) on the port
# ---------------------------------------------------------------------------

def make_column(L=20, ps=1.0e5, t_sfc=290.0, rh=0.5):
    """A single (1,1,L) column with uniform RH."""
    p_half = torch.linspace(100.0, ps, L + 1, dtype=torch.float64)
    p_full = 0.5 * (p_half[:-1] + p_half[1:])
    t = t_sfc * (p_full / ps) ** 0.12
    svp = tsvp.SatVaporPres(constants=tcs.EARTH, do_simple=True)
    q = rh * svp.qs(t, p_full)
    z = 8000.0 * torch.log(ps / p_full)
    return (p_half[None, None, :], p_full[None, None, :], t[None, None, :],
            q[None, None, :], z[None, None, :], svp)


def test_formulas_bounded_and_monotone_in_rh():
    p_half, p_full, t, q, z, svp = make_column()
    ps = p_half[..., -1]
    w = torch.zeros_like(p_full)
    qcl = torch.full_like(p_full, 1e-8)
    qs = svp.qs(t, p_full)
    for formula in FORMULAS:
        cfg = tcs.LargeScaleCloudConfig(formula=formula)
        cf_lo, _ = tcs.large_scale_cloud_fraction(cfg, p_full, ps, 0.5 + 0 * p_full,
                                                  0.5 * qs, qs, qcl, w)
        cf_hi, _ = tcs.large_scale_cloud_fraction(cfg, p_full, ps, 0.99 + 0 * p_full,
                                                  0.99 * qs, qs, qcl, w)
        assert bool(((cf_lo >= 0.0) & (cf_lo <= 1.0)).all()), formula
        assert bool((cf_hi >= cf_lo - 1e-12).all()), formula
        if formula in ("LINEAR", "SPOOKIE", "SUNDQVIST", "SLINGO"):
            cf_sat, _ = tcs.large_scale_cloud_fraction(
                cfg, p_full, ps, 1.0 + 0 * p_full, qs, qs, qcl, w)
            np.testing.assert_allclose(cf_sat.numpy(), 1.0, atol=1e-6)


def test_linear_formula_closed_form():
    cfg = tcs.LargeScaleCloudConfig(formula="LINEAR")
    p_full = torch.tensor([[[9.0e4]]], dtype=torch.float64)
    ps = torch.tensor([[1.0e5]], dtype=torch.float64)
    rh = torch.tensor([[[0.98]]], dtype=torch.float64)
    cf, _ = tcs.large_scale_cloud_fraction(cfg, p_full, ps, rh, rh, rh * 0 + 1,
                                           rh * 0, rh * 0)
    a = cfg.linear_a_top + (cfg.linear_a_surf - cfg.linear_a_top) * np.exp(
        1.0 - (1.0e5 / 9.0e4) ** cfg.linear_power)
    np.testing.assert_allclose(float(cf[0, 0, 0]), np.clip(a * (0.98 - 1.0) + 1.0, 0, 1),
                               rtol=1e-6)


def test_omega_adjustment_and_freezedry():
    p_half, p_full, t, q, z, svp = make_column()
    ps = p_half[..., -1]
    cfg = tcs.LargeScaleCloudConfig(formula="LINEAR", do_adjust_cld_by_omega=True)
    rh = torch.full_like(p_full, 0.995)
    cf, _ = tcs.large_scale_cloud_fraction(cfg, p_full, ps, rh, q, q / rh, q * 0,
                                           torch.full_like(p_full, 0.5))
    assert bool((cf[p_full > cfg.adj_pres_threshold] == 0.0).all())
    p_half, p_full, t, q, z, svp = make_column(t_sfc=250.0)
    qdry = torch.full_like(p_full, 1e-5)
    rh = torch.full_like(p_full, 0.99)
    w = torch.zeros_like(p_full)
    base, fd = (tcs.LargeScaleCloudConfig(formula="LINEAR", do_freezedry=f)
                for f in (False, True))
    cf0, _ = tcs.large_scale_cloud_fraction(base, p_full, ps, rh, qdry, qdry / rh, q * 0, w)
    cf1, _ = tcs.large_scale_cloud_fraction(fd, p_full, ps, rh, qdry, qdry / rh, q * 0, w)
    assert bool((cf1 <= cf0 + 1e-12).all()) and bool((cf1 < cf0 - 1e-3).any())
    assert bool((cf1 >= 0.15 * cf0 - 1e-12).all())


def test_cover_overlaps_closed_form():
    cf = torch.tensor([[[0.0, 0.3, 0.5, 0.0, 0.2, 0.4, 0.0]]], dtype=torch.float64)
    p_full = torch.linspace(2.0e4, 9.5e4, 7, dtype=torch.float64)[None, None, :]
    p_half = torch.linspace(1.8e4, 1.0e5, 8, dtype=torch.float64)[None, None, :]
    out = tcs.cloud_cover_diags(cf, p_full, p_half, "MAXIMUM-RANDOM")
    np.testing.assert_allclose(float(out["tot_cld_amt"][0, 0]),
                               (1.0 - 0.5 * 0.6) * 100.0, rtol=1e-6)
    cf = torch.tensor([[[0.2, 0.5, 0.1]]], dtype=torch.float64)
    p_full = torch.tensor([[[3.0e4, 5.0e4, 8.0e4]]], dtype=torch.float64)
    p_half = torch.tensor([[[2.5e4, 4.0e4, 6.0e4, 1.0e5]]], dtype=torch.float64)
    mx = tcs.cloud_cover_diags(cf, p_full, p_half, "MAXIMUM")
    rnd = tcs.cloud_cover_diags(cf, p_full, p_half, "RANDOM")
    got = [float(d[k][0, 0]) for d, k in ((mx, "tot_cld_amt"), (rnd, "tot_cld_amt"),
                                          (mx, "high_cld_amt"), (mx, "mid_cld_amt"),
                                          (mx, "low_cld_amt"))]
    np.testing.assert_allclose(got, [50.0, (1 - 0.8 * 0.5 * 0.9) * 100.0, 20.0, 50.0, 10.0],
                               rtol=1e-6)


def test_driver_phase_partition_and_marine_strat():
    svp = tsvp.SatVaporPres(constants=tcs.EARTH, do_simple=True)
    scheme = tcs.CloudSimple(tcs.CloudSimpleConfig(), svp)
    p_half, p_full, t, q, z, _ = make_column(t_sfc=300.0)
    res = scheme(p_half, p_full, t, q, z, torch.zeros_like(p_full), p_half[..., -1])
    warm = t > tcs.EARTH.tfreeze + scheme.config.T_max
    cold = t < tcs.EARTH.tfreeze + scheme.config.T_min
    assert bool((res.frac_liq[warm] == 1.0).all()) and bool((res.frac_liq[cold] == 0.0).all())
    assert bool((res.reff_rad >= 14.0 - 1e-9).all()) and bool((res.reff_rad <= 25.0 + 1e-9).all())
    assert bool((res.qcl_rad[res.cf == 0.0] == 0.0).all())
    # a subsiding ocean column with a sharp low-level inversion gains cloud
    L, ps = 25, 1.0e5
    p_half = torch.linspace(100.0, ps, L + 1, dtype=torch.float64)[None, None, :]
    p_full = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
    t = 288.0 * (p_full / ps) ** 0.12 + torch.exp(-((p_full - 9.0e4) / 2.0e3) ** 2) * 12.0
    q = 0.6 * svp.qs(t, p_full)
    z = 8000.0 * torch.log(ps / p_full)
    w = torch.full_like(p_full, 0.05)
    r0 = tcs.CloudSimple(tcs.CloudSimpleConfig(), svp)(p_half, p_full, t, q, z, w,
                                                       p_half[..., -1])
    for method in ("EIS_WOOD",) + METHODS:
        strat = tcs.CloudSimple(tcs.CloudSimpleConfig(
            do_add_stratocumulus=True, marine_strat=tcs.MarineStratConfig(method=method)), svp)
        r1 = strat(p_half, p_full, t, q, z, w, p_half[..., -1])
        assert bool(((r1.cf >= 0.0) & (r1.cf <= 1.0)).all()), method
        if method == "EIS_WOOD":
            assert float((r1.cf - r0.cf).max()) > 0.05
    z_sat, z_50, z_30 = (float(tcs.lcl_height(torch.tensor(290.0, dtype=torch.float64),
                                              torch.tensor(rh, dtype=torch.float64),
                                              tcs.EARTH)) for rh in (1.0, 0.5, 0.3))
    assert z_sat < 30.0 and 1000.0 < z_50 < 2500.0 and z_30 > z_50


def test_spookie_protocols_bounded_and_saturated():
    p_half, p_full, t, q, z, svp = make_column(L=20, rh=0.9)
    for proto in (1, 2):
        cf, _, reff, qcl, _ = tcs.cloud_spookie(
            tcs.CloudSpookieConfig(spookie_protocol=proto), svp, p_full, t, q)
        assert bool(((cf >= 0.0) & (cf <= 1.0)).all()) and bool(torch.isfinite(qcl).all())
        assert bool(((reff >= 10.0 - 1e-6) & (reff <= 20.0 + 1e-6)).all())
    cfg = tcs.CloudSpookieConfig()
    cf, _, _, _, _ = tcs.cloud_spookie(cfg, svp, p_full, t, svp.qs(t, p_full))
    np.testing.assert_allclose(cf[p_full < cfg.p_base].numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("scheme", ["do_cloud_simple", "do_cloud_spookie"])
def test_cloud_diagnostics_in_the_gcm(scheme):
    """tests/test_cloud_simple.py's driver integration: the GCM at T21L10
    with grey radiation emits the cloud diagnostics."""
    cfg = tmoist.GreyMoistConfig()
    cfg = dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, resolution="T21", num_levels=10,
                                      dtype=torch.float64),
        physics=dataclasses.replace(cfg.physics, **{scheme: True}))
    model = tmoist.GreyMoistModel(cfg, device="cpu")
    _, diag = model.step_with_diagnostics(model.initial_state(), first=True)
    keys = (("cf", "reff_rad", "qcl_rad", "tot_cld_amt") if scheme == "do_cloud_simple"
            else ("cf", "rh_min"))
    for key in keys:
        assert key in diag, key
    assert bool(torch.isfinite(diag["cf"]).all())


def test_configs_mirror_isca_tpu():
    """The cloud schemes' configurations have isca_tpu's fields, in its
    order, with its defaults; the driver's cloud fields too."""
    from isca_tpu.physics import moist_driver as jmd
    from isca_tpu_torch.physics import moist_driver as tmd

    for name in ("LargeScaleCloudConfig", "MarineStratConfig", "CloudSimpleConfig",
                 "CloudSpookieConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jcs, name))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(tcs, name))}
        assert list(tf) == list(jf), name
        for k, v in jf.items():
            if k not in ("constants", "large_scale", "marine_strat"):
                assert tf[k] == v, (name, k)
    jf = {f.name: f.default for f in dataclasses.fields(jmd.MoistPhysicsConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tmd.MoistPhysicsConfig)}
    for k in ("do_cloud_simple", "do_cloud_spookie", "spookie", "socrates"):
        assert tf[k] == jf[k], k
