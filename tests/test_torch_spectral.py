"""isca_tpu_torch.spectral against isca_tpu.spectral: the Gauss/Legendre
tables, every table of make_transforms, and every transform and operator.

Inputs are made with numpy from a seed and go through both packages at
float64 on the CPU, for T21 and T42, triangular and rhomboidal truncation,
fourier_inc=2, make_symmetric, a padded m axis, and both the dense-DFT and
the FFT longitude stage.

Tolerances: the tables are built by the same numpy code, so they are equal
bit for bit. Elementwise operators agree to rtol 1e-12. Contractions (the
DFT/FFT, Legendre and area-mean stages, and whatever is built on them) sum
in another order than XLA does, so an entry that is small through
cancellation can differ by more than 1e-12 of itself: they are held to
1e-12 of the largest entry of the compared array (atol), with rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.spectral import gauss as jgauss
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch.spectral import gauss as tgauss
from isca_tpu_torch.spectral import transforms as ttr

RTOL = 1e-12

CONFIGS = {
    "T21": ("T21", {}),
    "T42": ("T42", {}),
    "T21_fft": ("T21", dict(fourier_method="fft")),
    "T42_fft": ("T42", dict(fourier_method="fft")),
    "T21_rhomboidal": (10, dict(nlon=96, nlat=48, truncation_shape="rhomboidal")),
    "T42_rhomboidal": (21, dict(nlon=128, nlat=64, truncation_shape="rhomboidal")),
    "T21_fourier_inc2": ("T21", dict(fourier_inc=2)),
    "T21_symmetric": ("T21", dict(make_symmetric=True)),
    "T21_pad_m": ("T21", dict(pad_m_to=8)),
    "T21_fft_pad_m": ("T21", dict(pad_m_to=8, fourier_method="fft")),
}

_CACHE = {}


def pair(name):
    """(isca_tpu tables, isca_tpu_torch tables) for one configuration, float64."""
    if name not in _CACHE:
        trunc, kw = CONFIGS[name]
        _CACHE[name] = (jtr.make_transforms(trunc, dtype=jnp.float64, **kw),
                        ttr.make_transforms(trunc, dtype=torch.float64, device="cpu", **kw))
    return _CACHE[name]


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, scaled=True, rtol=RTOL, msg=""):
    """port (tensor) against ref (jax/numpy); `scaled` adds atol = rtol x max|ref|."""
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (msg, port.shape, ref.shape)
    atol = rtol * float(np.abs(ref).max()) if scaled and ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=msg)


def random_spec(jT, seed, nlev=3):
    """Random triangle-truncated spectral field with real zonal-mean modes
    (numpy; the same values go to both packages)."""
    rng = np.random.default_rng(seed)
    shape = (nlev, jT.num_fourier + 1, jT.num_spherical + 1)
    s = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    s[..., 0, :] = s[..., 0, :].real
    return s * np.asarray(jT.triangle)


def random_grid(jT, seed, nlev=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nlev, jT.nlat, jT.nlon))


# ---------------------------------------------------------------------------
# gauss.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nlat", [32, 64, 128])
def test_gauss_tables_identical(nlat):
    for a, b in zip(tgauss.gauss_legendre(nlat), jgauss.gauss_legendre(nlat)):
        np.testing.assert_array_equal(a, b)
    mu, _ = jgauss.gauss_legendre(nlat)
    M = nlat * 2 // 3
    np.testing.assert_array_equal(tgauss.legendre_table(mu, M, M + 1),
                                  jgauss.legendre_table(mu, M, M + 1))
    np.testing.assert_array_equal(tgauss.epsilon_table(M, M + 2),
                                  jgauss.epsilon_table(M, M + 2))


# ---------------------------------------------------------------------------
# make_transforms tables
# ---------------------------------------------------------------------------

TABLES = ("wts", "sinlat", "coslat", "lats", "lons", "P", "Pw", "eps", "mvec", "nn1",
          "inv_nn1", "triangle", "eigenvalues", "uv_im", "uv_cm", "uv_cp", "vd_im",
          "vd_dn", "vd_up", "cdl_up", "cdl_dn", "inv_eig", "dft_cos_f", "dft_sin_f",
          "dft_cos_i", "dft_sin_i", "dft_ana", "dft_syn")
META = ("truncation", "num_fourier", "num_fourier_true", "num_spherical", "nlon",
        "nlat", "radius", "fourier_method", "spec_shape", "grid_shape")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_identical(name):
    jT, tT = pair(name)
    for k in META:
        assert getattr(tT, k) == getattr(jT, k), k
    for k in TABLES:
        a, b = getattr(tT, k), np.asarray(getattr(jT, k))
        assert a.dtype == torch.float64 and a.device.type == "cpu", k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert tT.cdtype == torch.complex128


def test_float32_tables_round_like_jax():
    jT = jtr.make_transforms("T21", dtype=jnp.float32)
    tT = ttr.make_transforms("T21", dtype=torch.float32, device="cpu")
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tT, k).numpy(), np.asarray(getattr(jT, k)),
                                      err_msg=k)
    assert tT.cdtype == torch.complex64


def test_unported_options_raise():
    # the sharded transforms are ported (tests/test_torch_parallel.py); a
    # mesh that is not a parallel.mesh.Mesh still raises
    with pytest.raises(TypeError, match="Mesh"):
        ttr.make_transforms("T21", device="cpu", mesh=object())
    # "high" and "default" are ported (tests/test_torch_precision.py); a
    # name jax.lax.Precision lacks raises
    for precision in ("high", "default"):
        assert ttr.make_transforms("T21", device="cpu", precision=precision).prec == precision
    with pytest.raises(ValueError, match="precision"):
        ttr.make_transforms("T21", device="cpu", precision="fastest")
    with pytest.raises(ValueError, match="fourier_inc"):
        ttr.make_transforms("T21", device="cpu", fourier_inc=2, fourier_method="fft")
    with pytest.raises(ValueError, match="truncation_shape"):
        ttr.make_transforms("T21", device="cpu", truncation_shape="pentagonal")


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_fourier_stage_matches(name):
    jT, tT = pair(name)
    g = random_grid(jT, 1)
    jF = jtr.grid_to_fourier(jT, jnp.asarray(g))
    tF = ttr.grid_to_fourier(tT, T(g))
    assert tF.dtype == torch.complex128
    close(tF, jF, msg="grid_to_fourier")
    F = np.asarray(jF)
    close(ttr.fourier_to_grid(tT, T(F)), jtr.fourier_to_grid(jT, jnp.asarray(F)),
          msg="fourier_to_grid")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legendre_stage_matches(name):
    jT, tT = pair(name)
    F = np.asarray(jtr.grid_to_fourier(jT, jnp.asarray(random_grid(jT, 2))))
    close(ttr.fourier_to_spec(tT, T(F)), jtr.fourier_to_spec(jT, jnp.asarray(F)),
          msg="fourier_to_spec")
    s = random_spec(jT, 3)
    close(ttr.spec_to_fourier(tT, T(s)), jtr.spec_to_fourier(jT, jnp.asarray(s)),
          msg="spec_to_fourier")
    # unbatched (lat, m) and doubly batched inputs take the same path
    close(ttr.spec_to_fourier(tT, T(s[0])), jtr.spec_to_fourier(jT, jnp.asarray(s[0])))
    s4 = s.reshape((1,) + s.shape)
    close(ttr.spec_to_fourier(tT, T(s4)), jtr.spec_to_fourier(jT, jnp.asarray(s4)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_transforms_match(name):
    jT, tT = pair(name)
    g = random_grid(jT, 4)
    for truncate in (True, False):
        close(ttr.grid_to_spec(tT, T(g), truncate=truncate),
              jtr.grid_to_spec(jT, jnp.asarray(g), truncate=truncate),
              msg=f"grid_to_spec truncate={truncate}")
    s = random_spec(jT, 5)
    close(ttr.spec_to_grid(tT, T(s)), jtr.spec_to_grid(jT, jnp.asarray(s)), msg="spec_to_grid")
    close(ttr.spec_to_grid(tT, T(s[1])), jtr.spec_to_grid(jT, jnp.asarray(s[1])))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spectral_operators_match(name):
    """Elementwise in spectral space: rtol 1e-12 of each entry."""
    jT, tT = pair(name)
    s = random_spec(jT, 6)
    js, ts = jnp.asarray(s), T(s)
    close(ttr.triangular_truncate(tT, ts), jtr.triangular_truncate(jT, js), scaled=False)
    for power in (1, 2):
        close(ttr.laplacian(tT, ts, power), jtr.laplacian(jT, js, power), scaled=False)
    close(ttr.inverse_laplacian(tT, ts), jtr.inverse_laplacian(jT, js), scaled=False)
    close(ttr.ddx_spec(tT, ts), jtr.ddx_spec(jT, js), scaled=False)
    close(ttr.cos_dlat_coeffs(tT, ts), jtr.cos_dlat_coeffs(jT, js), scaled=False)
    s2 = random_spec(jT, 7)
    for a, b in zip(ttr.uv_coeffs_from_vor_div(tT, ts, T(s2)),
                    jtr.uv_coeffs_from_vor_div(jT, js, jnp.asarray(s2))):
        close(a, b, scaled=False)
    for truncate in (True, False):
        for a, b in zip(ttr.vor_div_from_analysis(tT, ts, T(s2), truncate=truncate),
                        jtr.vor_div_from_analysis(jT, js, jnp.asarray(s2), truncate=truncate)):
            close(a, b, scaled=False)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_wind_transforms_match(name):
    jT, tT = pair(name)
    vor, div = random_spec(jT, 8), random_spec(jT, 9)
    ju, jv = jtr.uv_grid_from_vor_div(jT, jnp.asarray(vor), jnp.asarray(div))
    tu, tv = ttr.uv_grid_from_vor_div(tT, T(vor), T(div))
    close(tu, ju, msg="u")
    close(tv, jv, msg="v")
    u, v = np.asarray(ju), np.asarray(jv)
    for truncate in (True, False):
        for a, b in zip(ttr.vor_div_from_uv_grid(tT, T(u), T(v), truncate=truncate),
                        jtr.vor_div_from_uv_grid(jT, jnp.asarray(u), jnp.asarray(v),
                                                 truncate=truncate)):
            close(a, b, msg=f"vor_div truncate={truncate}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_advection_means_coriolis_match(name):
    jT, tT = pair(name)
    f = random_spec(jT, 10, nlev=2)
    u, v = random_grid(jT, 11, nlev=2), random_grid(jT, 12, nlev=2)
    close(ttr.horizontal_advection(tT, T(f), T(u), T(v)),
          jtr.horizontal_advection(jT, jnp.asarray(f), jnp.asarray(u), jnp.asarray(v)))
    g = 1e5 + random_grid(jT, 13)
    close(ttr.area_weighted_mean(tT, T(g)), jtr.area_weighted_mean(jT, jnp.asarray(g)))
    close(ttr.coriolis_grid(tT, 7.292e-5), jtr.coriolis_grid(jT, 7.292e-5), scaled=False)
