"""isca_tpu_torch's SOCRATES radiation (physics/socrates.py,
socrates_spectral.py, socrates_interface.py) against isca_tpu.

* Spectral files: the port's copy of the numpy spectral layer builds the
  same synthetic spectra, writes the same bytes, reads back what it wrote,
  and reads tests/data/sp_lw_mini_ukmo into the same SpectrumData as
  isca_tpu's reader, field by field and exactly; the g-point packing
  (band_of_g, w_g and every other packed table) is equal exactly, so the
  g order (dict and list insertion order) is isca_tpu's.
* Module by module on seeded columns (2 x 4 columns, 20 levels):
  SocratesGasOptics (SW: Rayleigh and minor gases; LW: continuum, minor
  gases), cloud_optics, planck_bands, lw_down_solve / lw_up_solve (clear
  and cloudy), and SocratesRadiation.down/up (clear and cloudy, the diurnal
  sun and Frierson's, the stashed _lw_down/_sw_heat/_sw_up contract) at
  float64, every output at rtol 1e-10 of its largest entry; and at float32,
  the dtype the driver builds SOCRATES in. XLA's float32 exp, log and pow
  differ from torch's by one ulp in a few percent of arguments. The modules
  are held at RTOL_F32 = 1e-5 of each field's largest entry (measured here:
  under 3e-6). The whole scheme amplifies ulps where the sun grazes (coszen
  is a difference of two terms; the beam is exp(-tau / mu0)) and in heating
  rates (differences of fluxes), so each of its fields is held within
  GAP_FACTOR = 3 times isca_tpu's own float32-versus-float64 difference, as
  chip_smoke.py holds the card to the CPU (measured here: 2.5 at most, in
  olr; the gap itself reaches 5.5e-3 of the largest SW heating rate).
* The reference's physical checks (tests/test_socrates.py) on the port;
  its aquaplanet runs are tests/test_torch_socrates_gcm.py's.
"""

import dataclasses
import filecmp
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import socrates as js
from isca_tpu.physics import socrates_spectral as jspec
from isca_tpu_torch.physics import socrates as ts
from isca_tpu_torch.physics import socrates_spectral as tspec
from tests.test_torch_physics import columns
from tests.test_torch_socrates_gcm import one_torch_thread  # noqa: F401 (autouse)

DATA = pathlib.Path(__file__).resolve().parent / "data" / "sp_lw_mini_ukmo"
RTOL = 1e-10
RTOL_F32 = 1e-5
GAP_FACTOR = 3.0


def T(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(a):
    return jnp.asarray(np.array(a))


def close(port, ref, rtol=RTOL, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    atol = rtol * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


def close_tuple(port, ref, rtol=RTOL, msg=""):
    for name in ref._fields:
        close(getattr(port, name), getattr(ref, name), rtol=rtol, msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# spectral files and packing
# ---------------------------------------------------------------------------

def spectra():
    return {"sw": (jspec.synthetic_sw_spectrum(), tspec.synthetic_sw_spectrum()),
            "lw": (jspec.synthetic_lw_spectrum(), tspec.synthetic_lw_spectrum()),
            "ukmo": (jspec.read_spectral_file(DATA, name="mini"),
                     tspec.read_spectral_file(DATA, name="mini"))}


def same_spectrum(a, b):
    """Every field of two SpectrumData equal exactly, lists and dicts in
    the same order."""
    for f in dataclasses.fields(jspec.SpectrumData):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "esft":
            assert list(x) == list(y)
            for k in x:
                for g in dataclasses.fields(jspec.GasFit):
                    np.testing.assert_array_equal(getattr(x[k], g.name),
                                                  getattr(y[k], g.name), err_msg=str(k))
        elif f.name == "continuum":
            assert list(x) == list(y)
            for k in x:
                assert [dataclasses.asdict(c) for c in x[k]] == \
                    [dataclasses.asdict(c) for c in y[k]]
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("which", ["sw", "lw", "ukmo"])
def test_spectra_and_packing_equal(which):
    a, b = spectra()[which]
    same_spectrum(a, b)
    pa, pb = js._pack(a), ts._pack(b)
    for name in pa._fields:
        np.testing.assert_array_equal(getattr(pb, name), getattr(pa, name), err_msg=name)
    go_j, go_t = js.SocratesGasOptics(a, jnp.float64), ts.SocratesGasOptics(
        b, torch.float64, device="cpu")
    np.testing.assert_array_equal(go_t.band_of_g.numpy(), np.asarray(go_j.band_of_g))
    np.testing.assert_array_equal(go_t.w_g.numpy(), np.asarray(go_j.w_g))
    if which == "sw":
        assert go_t.n_g == 28       # the G that sw_flux_solve meets in SOCRATES


def test_writer_bytes_and_round_trip(tmp_path):
    for a, b in list(spectra().values())[:2]:
        pj, pt = tmp_path / f"{a.name}.jax", tmp_path / f"{a.name}.torch"
        jspec.write_spectral_file(a, pj)
        tspec.write_spectral_file(b, pt)
        assert filecmp.cmp(pj, pt, shallow=False)
        back = tspec.read_spectral_file(pt, name="back")
        same_spectrum(back, jspec.read_spectral_file(pj, name="back"))
        # the reference's round-trip checks
        assert back.n_band == b.n_band and back.absorbers == b.absorbers
        assert back.band_gases == b.band_gases and set(back.esft) == set(b.esft)
        np.testing.assert_allclose(back.wl_short, b.wl_short, rtol=1e-8)
        for key, fit in b.esft.items():
            np.testing.assert_allclose(back.esft[key].k, fit.k, rtol=1e-8)
            np.testing.assert_allclose(back.esft[key].w, fit.w, rtol=1e-8)
        np.testing.assert_allclose(back.drop_coeffs, b.drop_coeffs, rtol=1e-8)
        if b.is_sw:
            np.testing.assert_allclose(back.solar_frac, b.solar_frac, rtol=1e-8)
        else:
            np.testing.assert_allclose(back.planck, b.planck, rtol=1e-7)


def test_band_planck_flux_and_fit_match():
    for wl in ((4e-6, 1.5e-5), (1.5e-5, 1e-3)):
        for temp in (200.0, np.array([250.0, 300.0])):
            np.testing.assert_array_equal(tspec.band_planck_flux(*wl, temp),
                                          jspec.band_planck_flux(*wl, temp))
    lw = tspec.synthetic_lw_spectrum()
    np.testing.assert_array_equal(tspec.fit_planck_polynomial(lw.wl_short, lw.wl_long),
                                  jspec.fit_planck_polynomial(lw.wl_short, lw.wl_long))


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

DTYPES = {"float64": (jnp.float64, torch.float64, RTOL),
          "float32": (jnp.float32, torch.float32, RTOL_F32)}


def col(seed=0, L=20):
    c = columns(seed, L=L)
    rng = np.random.default_rng(seed + 100)
    cf = np.where(rng.uniform(0, 1, c["t"].shape) > 0.4, rng.uniform(0, 1, c["t"].shape), 0.0)
    c.update(cf=cf, reff=rng.uniform(5.0, 30.0, cf.shape), qcl=cf * rng.uniform(0, 3e-4),
             frac_liq=np.clip(rng.uniform(-0.3, 1.3, cf.shape), 0.0, 1.0),
             albedo=rng.uniform(0.05, 0.4, cf.shape[:-1]),
             d_mass=(c["p_half"][..., 1:] - c["p_half"][..., :-1]) / 9.8)
    return c


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["sw", "lw", "ukmo"])
def test_gas_optics_matches(which, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    a, b = spectra()[which]
    c = col(1)
    mmr = {jspec.IP_H2O: c["q"], jspec.IP_CO2: 4.6e-4, jspec.IP_O3: 1e-6,
           jspec.IP_O2: 0.2314, jspec.IP_CH4: 1e-6, jspec.IP_N2O: 5e-7}
    jm = {k: J(v) if isinstance(v, np.ndarray) else v for k, v in mmr.items()}
    tm = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in mmr.items()}
    args = ("p_full", "t", "d_mass")
    ref = js.SocratesGasOptics(a, jdt)(*(J(c[k]) for k in args), jm)
    out = ts.SocratesGasOptics(b, tdt, device="cpu")(*(T(c[k]) for k in args), tm)
    assert out.tau_abs.dtype == tdt
    close_tuple(out, ref, rtol=rtol, msg=f"{which} {dtype}")
    assert float(np.asarray(ref.tau_abs).max()) > 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cloud_optics_and_planck_match(dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    c = col(2)
    for (a, b) in list(spectra().values())[:2]:
        go = ts.SocratesGasOptics(b, tdt, device="cpu")
        for coeffs in (a.drop_coeffs, a.ice_coeffs):
            ref = js.cloud_optics(coeffs, np.asarray(go.band_of_g), J(c["qcl"] * 1e4),
                                  J(c["reff"]), jdt)
            out = ts.cloud_optics(coeffs, go.band_of_g, T(c["qcl"] * 1e4, tdt),
                                  T(c["reff"], tdt), tdt)
            for x, y, name in zip(out, ref, ("tau", "ssa", "asy")):
                close(x, y, rtol=rtol, msg=name)
    lw = spectra()["lw"][0]
    for temp in (c["t"], c["t_surf"], np.float64(255.0)):
        close(ts.planck_bands(lw.planck, lw.t_ref_planck, T(temp, tdt), tdt),
              js.planck_bands(lw.planck, lw.t_ref_planck, J(temp), jdt), rtol=rtol)


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lw_solves_match(dtype, cloudy):
    jdt, tdt, rtol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    c = col(3)
    lw = spectra()["lw"][0]
    G, L = 14, c["t"].shape[-1]
    band = rng.integers(0, lw.n_band, G)
    tau = rng.gamma(1.0, 0.5, c["t"].shape + (G,)) * (rng.uniform(0, 1, G) > 0.2)
    tau_cld = rng.gamma(1.0, 2.0, c["t"].shape + (G,))
    t_half = np.concatenate([c["t"][..., :1], 0.5 * (c["t"][..., 1:] + c["t"][..., :-1]),
                             c["t"][..., -1:]], axis=-1)
    planck = lambda temp: np.asarray(js.planck_bands(lw.planck, lw.t_ref_planck,
                                                     J(temp), jnp.float64))[..., band]
    blay, blev, bsfc = planck(c["t"]), planck(t_half), planck(c["t_surf"])
    w = rng.dirichlet(np.ones(G))
    cf = c["cf"] if cloudy else None
    jd = js.lw_down_solve(J(tau).astype(jdt), J(tau_cld).astype(jdt) if cloudy else None,
                          J(cf).astype(jdt) if cloudy else None, J(blay).astype(jdt),
                          J(blev).astype(jdt), J(w).astype(jdt))
    td = ts.lw_down_solve(T(tau, tdt), T(tau_cld, tdt) if cloudy else None,
                          T(cf, tdt) if cloudy else None, T(blay, tdt), T(blev, tdt),
                          T(w, tdt))
    close_tuple(td, jd, rtol=rtol, msg="down")
    for eps in (1.0, 0.9):
        ju = js.lw_up_solve(jd, J(bsfc).astype(jdt), eps)
        tu = ts.lw_up_solve(td, T(bsfc, tdt), eps)
        for x, y, name in zip(tu, ju, ("uflx", "olr")):
            close(x, y, rtol=rtol, msg=f"{name} {eps}")
    assert tuple(td.dflx.shape) == c["t"].shape[:-1] + (L + 1,)


RAD_CASES = {
    "diurnal": dict(),
    "frierson_sun": dict(frierson_solar_rad=True),
    "more_gases": dict(inc_n2o=True, inc_ch4=True, inc_o2=True, inc_cfc11=True,
                       o3_mmr=1e-6, input_planet_emissivity=0.95, co2_ppmv=600.0),
}


def radiation_pair(case, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    kw = dict(RAD_CASES[case], stellar_constant=1370.0)
    return (js.SocratesRadiation(js.SocratesConfig(**kw), dtype=jdt),
            ts.SocratesRadiation(ts.SocratesConfig(**kw), dtype=tdt, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_radiation(case, dtype, cloudy):
    """isca_tpu's down, up and stash on RAD_COLUMNS, under jax.jit (each
    float64 result serves its float32 test too)."""
    c = col(RAD_COLUMNS)
    j = radiation_pair(case, dtype)[0]
    names = ("lat", "lon", "p_half", "t", "q", "albedo")
    cloud = ("cf", "reff", "qcl", "frac_liq") if cloudy else ()

    def run(*a):
        kw = dict(cloud_fields=a[6:]) if cloudy else {}
        d = j.down(*a[:6], gmt=J(GMT), time_since_ae=J(TSAE), dt_rad_avg=0.05, **kw)
        return d, j.up(d, a[2], J(c["t_surf"]), a[5]), j._lw_down, j._sw_heat, j._sw_up
    return jax.jit(run)(*(J(c[k]) for k in names + cloud))


GMT, TSAE = np.float32(3.5), np.float32(4.2)
RAD_COLUMNS = 4


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("case", list(RAD_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_socrates_radiation_matches(dtype, case, cloudy):
    _, tdt, _ = DTYPES[dtype]
    c = col(RAD_COLUMNS)
    t = radiation_pair(case, dtype)[1]
    ref = jax_radiation(case, dtype, cloudy)
    kw = (dict(cloud_fields=tuple(T(c[k]) for k in ("cf", "reff", "qcl", "frac_liq")))
          if cloudy else {})
    d = t.down(*(T(c[k]) for k in ("lat", "lon", "p_half", "t", "q", "albedo")),
               gmt=T(GMT), time_since_ae=T(TSAE), dt_rad_avg=0.05, **kw)
    # up() reads what down() stashed on the instance
    out = (d, t.up(d, T(c["p_half"]), T(c["t_surf"]), T(c["albedo"])),
           t._lw_down, t._sw_heat, t._sw_up)
    flat = lambda r: {f"{i}.{k}": v for i, x in enumerate(r[:3]) for k, v in x._asdict().items()}
    got, want = flat(out), flat(ref)
    got.update(sw_heat=out[3], sw_up=out[4])
    want.update(sw_heat=ref[3], sw_up=ref[4])
    if dtype == "float64":
        for k, b in want.items():
            close(got[k], b, msg=f"{case} {k}")
    else:
        r64 = jax_radiation(case, "float64", cloudy)
        want64 = flat(r64)
        want64.update(sw_heat=r64[3], sw_up=r64[4])
        for k, b in want.items():
            a, b, b64 = (np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float64)
                         for x in (got[k], b, want64[k]))
            assert np.abs(a - b).max() <= GAP_FACTOR * np.abs(b - b64).max(), (case, k)
    assert out[1].tdt_rad.dtype == tdt
    sw = np.asarray(ref[0].sw_down)
    night = np.asarray(ref[0].coszen) <= 0.0
    assert (sw[night] == 0.0).all() and (sw[~night] > 0.0).any()


def test_socrates_interface_reexport():
    from isca_tpu_torch.physics.socrates_interface import SocratesConfig, SocratesRadiation
    assert SocratesConfig is ts.SocratesConfig and SocratesRadiation is ts.SocratesRadiation


# ---------------------------------------------------------------------------
# the reference's physical checks (tests/test_socrates.py) on the port
# ---------------------------------------------------------------------------

F32 = torch.float32


def _column(L=20):
    p_half = torch.linspace(1.0, 1.0e5, L + 1, dtype=F32)
    p_full = 0.5 * (p_half[1:] + p_half[:-1])
    t = 220.0 + 70.0 * (p_full / p_full[-1]) ** 0.6
    q = 0.018 * (p_full / p_full[-1]) ** 3
    return p_half, p_full, t, q


def rad(**kw):
    return ts.SocratesRadiation(ts.SocratesConfig(**kw), device="cpu")


def test_solar_fractions_planck_and_esft_weights():
    sw = tspec.synthetic_sw_spectrum()
    assert abs(sw.solar_frac.sum() - 1.0) < 1e-12
    lw = tspec.synthetic_lw_spectrum()
    for temp in (200.0, 255.0, 300.0):
        tot = float(ts.planck_bands(lw.planck, lw.t_ref_planck,
                                    torch.tensor(temp, dtype=F32), F32).sum())
        exact = sum(tspec.band_planck_flux(lw.wl_short[b], lw.wl_long[b], temp)
                    for b in range(lw.n_band))
        assert abs(tot - exact) / exact < 0.01
        assert 0.8 * ts.STEFAN * temp**4 < tot < 1.02 * ts.STEFAN * temp**4
    go = ts.SocratesGasOptics(sw, device="cpu")
    w = np.zeros(go.n_band)
    np.add.at(w, go.band_of_g.numpy(), go.w_g.numpy())
    np.testing.assert_allclose(w, 1.0, rtol=1e-6)


def test_gas_optics_monotone_in_absorber():
    go = ts.SocratesGasOptics(tspec.synthetic_lw_spectrum(), device="cpu")
    p_half, p_full, t, q = _column()
    d_mass = (p_half[1:] - p_half[:-1]) / 9.8
    lo = go(p_full, t, d_mass, {tspec.IP_H2O: q, tspec.IP_CO2: 4.6e-4})
    hi = go(p_full, t, d_mass, {tspec.IP_H2O: 2 * q, tspec.IP_CO2: 9.2e-4})
    assert tuple(lo.tau_abs.shape) == (20, go.n_g)
    assert bool((hi.tau_abs >= lo.tau_abs).all()) and bool((lo.tau_abs >= 0).all())
    assert float(go(p_full, t, d_mass, {}).tau_abs.max()) == 0.0


def test_lw_isothermal_and_transparent_limits():
    L, T0 = 30, 260.0
    spec = tspec.synthetic_lw_spectrum()
    nb = spec.n_band
    blay = ts.planck_bands(spec.planck, spec.t_ref_planck, torch.full((L,), T0), F32)
    blev = ts.planck_bands(spec.planck, spec.t_ref_planck, torch.full((L + 1,), T0), F32)
    tau = torch.full((L, nb), 50.0)
    w_g = torch.ones(nb)
    down = ts.lw_down_solve(tau, None, None, blay, blev, w_g)
    btot = float(blay[0].sum())
    assert abs(float(down.dflx[-1]) - btot) / btot < 1e-4
    _, olr = ts.lw_up_solve(down, blev[-1], 1.0)
    assert abs(float(olr) - btot) / btot < 1e-4
    down0 = ts.lw_down_solve(torch.zeros_like(tau), None, None, blay, blev, w_g)
    assert float(down0.dflx[-1]) < 1e-3
    _, olr0 = ts.lw_up_solve(down0, blev[-1], 1.0)
    assert abs(float(olr0) - btot) / btot < 1e-5


def test_greenhouse_energy_budget_and_clouds():
    p_half, p_full, t, q = _column()
    lat, lon = torch.tensor(0.5), torch.tensor(0.0)
    t_surf, alb = t[-1] + 8.0, torch.tensor(0.3)
    lo_rad, hi_rad = rad(frierson_solar_rad=True), rad(frierson_solar_rad=True, co2_ppmv=1200.0)
    lo = lo_rad.down(lat, lon, p_half, t, q, alb)
    r_lo = lo_rad.up(lo, p_half, t_surf, alb)
    hi = hi_rad.down(lat, lon, p_half, t, q, alb)
    r_hi = hi_rad.up(hi, p_half, t_surf, alb)
    sig = ts.STEFAN * float(t_surf) ** 4
    assert float(r_hi.olr) < float(r_lo.olr) and 0.4 * sig < float(r_lo.olr) < 1.02 * sig
    assert float(hi.surf_lw_down) > float(lo.surf_lw_down)
    # SW budget with the sun at coszen 0.25 everywhere
    r = rad(frierson_solar_rad=True, del_sol=0.0, del_sw=0.0)
    d = r.down(torch.tensor(0.0), lon, p_half, t, q, torch.tensor(0.25))
    toa_in = r.config.stellar_constant * 0.25
    toa_net = float(d.sw_down[0] - r._sw_up[0])
    assert 0 < toa_net <= toa_in + 1e-3
    absorbed = float((r._sw_heat * (p_half[1:] - p_half[:-1]) * 1004.64 / 9.80).sum())
    assert abs(absorbed + float(d.net_surf_sw_down) - toa_net) < 2e-2 * toa_in
    # clouds brighten (less surface SW), warm (more surface LW down), cut OLR
    cfg = dict(frierson_solar_rad=True)
    lat, alb = torch.tensor(0.3), torch.tensor(0.1)
    r1 = rad(**cfg)
    clear = r1.down(lat, lon, p_half, t, q, alb)
    rc = r1.up(clear, p_half, t[-1], alb)
    cf = torch.where((p_full > 6e4) & (p_full < 9e4), 0.9, 0.0)
    r2 = rad(**cfg)
    cld = r2.down(lat, lon, p_half, t, q, alb, cloud_fields=(
        cf, torch.full_like(p_full, 12.0), torch.where(cf > 0, 2.0e-4, 0.0),
        torch.ones_like(p_full)))
    rcl = r2.up(cld, p_half, t[-1], alb)
    assert float(cld.net_surf_sw_down) < float(clear.net_surf_sw_down)
    assert float(cld.surf_lw_down) > float(clear.surf_lw_down)
    assert float(rcl.olr) < float(rc.olr)


def test_ukmo_file_end_to_end():
    spec = tspec.read_spectral_file(DATA)
    assert spec.n_band == 2 and spec.absorbers == [tspec.IP_H2O, tspec.IP_CO2]
    assert spec.band_gases == [[tspec.IP_H2O], [tspec.IP_H2O, tspec.IP_CO2]]
    r = ts.SocratesRadiation(ts.SocratesConfig(frierson_solar_rad=True),
                             sw_spectrum=tspec.synthetic_sw_spectrum(), lw_spectrum=spec,
                             device="cpu")
    L, ncol = 12, 3
    p_half = torch.linspace(10.0, 1.0e5, L + 1).expand(ncol, L + 1)
    t = torch.linspace(220.0, 290.0, L).expand(ncol, L)
    q = torch.full((ncol, L), 3e-3)
    lat, alb, ts_ = torch.zeros(ncol), torch.full((ncol,), 0.3), torch.full((ncol,), 295.0)
    olr = r.up(r.down(lat, lat, p_half, t, q, alb), p_half, ts_, alb).olr
    b = lambda temp: float(ts.planck_bands(spec.planck, spec.t_ref_planck,
                                           torch.tensor(temp), F32).sum())
    assert bool(torch.isfinite(olr).all())
    assert bool((olr > 0.5 * b(220.0)).all()) and bool((olr < b(295.0)).all())
    olr_dry = r.up(r.down(lat, lat, p_half, t, q * 0.1, alb), p_half, ts_, alb).olr
    assert bool((olr_dry > olr).all())


def test_config_mirrors_isca_tpu():
    jf = {f.name: f.default for f in dataclasses.fields(js.SocratesConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ts.SocratesConfig)}
    assert list(tf) == list(jf)
    for k, v in jf.items():
        if k != "constants":
            assert tf[k] == v, k
