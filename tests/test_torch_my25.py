"""isca_tpu_torch's Mellor-Yamada 2.5 closure (physics/my25_turb.py) against
isca_tpu.

* _thomas against isca_tpu's and against a dense solve (rtol 1e-10);
* my25_turb on tests/test_my25_turb.py's boundary-layer columns (neutral and
  stable, land, sea and mixed fractions), one update and 5 iterations, with
  the old constants and without the virtual-theta stability, every field at
  rtol 1e-10 with atol 1e-10 of each field's largest entry; tke_surf
  exactly;
* the port held to tests/goldens/bl_goldens.json's `my25` entry (60
  updates) at tests/test_bl_goldens.py's tolerance (rtol 1e-7, atol 1e-7 x
  the field's largest entry), and to that file's neutral log-layer
  equilibrium check;
* the physical checks of tests/test_my25_turb.py, on the port;
* float32: within 3x isca_tpu's own float32-versus-float64 difference of
  isca_tpu's float64 result (plus 1e-7 of the field's largest entry).
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import my25_turb as jm
from isca_tpu_torch.physics import my25_turb as tm

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_my25_turb import make_bl  # noqa: E402

RTOL = 1e-10
GOLDEN_RTOL = 1e-7          # tests/test_bl_goldens.py RTOL


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a, np.float64)).to(dtype)


def close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def test_thomas_matches():
    rng = np.random.default_rng(0)
    n = 12
    c = rng.uniform(-0.3, -0.1, (4, n))
    a = rng.uniform(-0.3, -0.1, (4, n))
    b = 1.0 - a - c
    d = rng.normal(size=(4, n))
    ref = np.asarray(jm._thomas(*map(jnp.asarray, (c, b, a, d))))
    got = tm._thomas(*map(T, (c, b, a, d))).numpy()
    close(torch.as_tensor(got), ref)
    for i in range(4):
        M = np.diag(b[i]) + np.diag(c[i, 1:], -1) + np.diag(a[i, :-1], 1)
        np.testing.assert_allclose(got[i], np.linalg.solve(M, d[i]), rtol=1e-10)


def inputs(stable=False, shear=5.0e-3):
    ph, pf, theta, u, v, zh, zf = make_bl(stable=stable, shear=shear)
    ncol, L = u.shape
    rng = np.random.default_rng(7)
    v = rng.normal(0.0, 1.0, u.shape)
    tke = np.abs(rng.normal(0.0, 0.3, (ncol, L + 1)))
    return (np.array([1.0, 0.0, 0.4]), ph, pf, theta, u, v, zh, zf,
            np.array([0.05, 1e-3, 0.2]), tke)


@pytest.mark.parametrize("stable,iters,kw", [
    (False, 1, {}), (True, 1, {}), (False, 5, {}),
    (False, 3, dict(use_old_cons=True, do_thv_stab=False, akmin_sea=1.0))])
def test_my25_matches(stable, iters, kw):
    args = inputs(stable)
    u_star = np.array([0.5, 0.2, 0.35])
    ref = jm.my25_turb(jm.MY25Config(**kw), 600.0, *map(jnp.asarray, args),
                       u_star=jnp.asarray(u_star), iters=iters)
    got = tm.my25_turb(tm.MY25Config(**kw), 600.0, *map(T, args), u_star=T(u_star),
                       iters=iters)
    assert float(np.asarray(ref.akm).max()) > 0.0
    for name in ref._fields:
        close(getattr(got, name), getattr(ref, name), what=name)


def test_tke_surf_matches():
    tke = np.random.default_rng(1).uniform(0.0, 1.0, (2, 11))
    u_star = np.array([0.4, 0.1])
    ref = jm.tke_surf(jm.MY25Config(), jnp.asarray(tke), jnp.asarray(u_star))
    got = tm.tke_surf(tm.MY25Config(), T(tke), T(u_star))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_my25_matches_golden():
    """tests/test_bl_goldens.py compute_my25: 60 updates from the surface
    TKE of u* = 0.3."""
    with open(REPO / "tests" / "goldens" / "bl_goldens.json") as f:
        golden = json.load(f)["my25"]
    ph, pf, theta, u, v, zh, zf = map(T, make_bl())
    cfg = tm.MY25Config()
    L = u.shape[-1]
    u_star = torch.full(u.shape[:-1], 0.3, dtype=torch.float64)
    tke = tm.tke_surf(cfg, torch.zeros(u.shape[:-1] + (L + 1,), dtype=torch.float64), u_star)
    z0 = torch.full(u.shape[:-1], 0.1, dtype=torch.float64)
    for _ in range(60):
        res = tm.my25_turb(cfg, 300.0, torch.zeros(u.shape[:-1], dtype=torch.float64), ph, pf,
                           theta, u, v, zh, zf, z0, tke, u_star=u_star)
        tke = res.tke
    for key, want in golden.items():
        want = np.asarray(want)
        np.testing.assert_allclose(getattr(res, key).numpy(), want, rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_RTOL * max(1.0, float(np.abs(want).max())),
                                   err_msg=key)


def test_my25_neutral_log_layer_equilibrium():
    """tests/test_bl_goldens.py's analytic anchors on the port: the surface
    TKE 0.5 B1^(2/3) u*^2, the neutral Prandtl number akm/akh = 0.788
    within 20% near the surface, and TKE of the surface value's order
    decreasing with height."""
    cfg = tm.MY25Config(akmin_land=0.0, akmin_sea=0.0)
    L, ncol = 20, 1
    z_half = np.linspace(2000.0, 0.0, L + 1)
    z_full = 0.5 * (z_half[:-1] + z_half[1:])
    p_half = 1.0e5 * np.exp(-z_half / 7500.0)
    p_full = 1.0e5 * np.exp(-z_full / 7500.0)
    u_star_v, z0v = 0.3, 0.1
    u = (u_star_v / cfg.vonkarm) * np.log(z_full / z0v)
    tile = lambda a: T(np.broadcast_to(a, (ncol,) + a.shape))
    ph, pf, zh, zf, uu = map(tile, (p_half, p_full, z_half, z_full, u))
    th = torch.full((ncol, L), 300.0, dtype=torch.float64)
    u_star = torch.full((ncol,), u_star_v, dtype=torch.float64)
    z0 = torch.full((ncol,), z0v, dtype=torch.float64)
    zero = torch.zeros((ncol,), dtype=torch.float64)
    tke = tm.tke_surf(cfg, torch.zeros((ncol, L + 1), dtype=torch.float64), u_star)
    step = lambda tk: tm.my25_turb(cfg, 300.0, zero, ph, pf, th, uu, torch.zeros_like(uu),
                                   zh, zf, z0, tk, u_star=u_star)
    for _ in range(300):
        res = step(tke)
        tke = res.tke
    assert float((step(tke).tke - tke).abs().max()) < 1e-2 * float(tke.max())
    bcq_tke = float(tke[0, -1])
    assert abs(bcq_tke - 0.5 * 16.0 ** (2.0 / 3.0) * u_star_v**2) < 1e-10
    aa1, aa2, bb1, cc1 = 0.92, 0.74, 16.0, 0.08
    pr_neutral = aa1 * (1 - 3 * cc1 - 6 * aa1 / bb1) / (aa2 * (1 - 6 * aa1 / bb1))
    ratio = (res.akm.numpy() / np.maximum(res.akh.numpy(), 1e-30))[0, -6:]
    assert np.all(np.abs(ratio / pr_neutral - 1.0) < 0.2), ratio
    tk = tke.numpy()[0]
    assert 0.3 * bcq_tke < tk[-2] < 1.2 * bcq_tke
    assert np.all(np.diff(tk[-8:-1]) > 0)


def test_float32_within_three_times_isca_tpus_gap():
    args = inputs()
    u_star = np.array([0.5, 0.2, 0.35])
    ref64 = jm.my25_turb(jm.MY25Config(), 600.0, *map(jnp.asarray, args),
                         u_star=jnp.asarray(u_star), iters=3)
    ref32 = jm.my25_turb(jm.MY25Config(), 600.0, *(jnp.asarray(a, jnp.float32) for a in args),
                         u_star=jnp.asarray(u_star, jnp.float32), iters=3)
    got = tm.my25_turb(tm.MY25Config(), 600.0, *(T(a, torch.float32) for a in args),
                       u_star=T(u_star, torch.float32), iters=3)
    assert got.tke.dtype == torch.float32
    for name in ref64._fields:
        want = np.asarray(getattr(ref64, name), np.float64)
        gap = float(np.abs(np.asarray(getattr(ref32, name), np.float64) - want).max())
        err = float(np.abs(getattr(got, name).numpy().astype(np.float64) - want).max())
        assert err <= 3.0 * gap + 1e-7 * float(np.abs(want).max()), (name, err, gap)


# ---------------------------------------------------------------------------
# the physical checks of tests/test_my25_turb.py
# ---------------------------------------------------------------------------

def port_run(iters=25, stable=False, ustar=0.5, shear=5.0e-3):
    cfg = tm.MY25Config()
    ph, pf, theta, u, v, zh, zf = map(T, make_bl(stable=stable, shear=shear))
    ncol, L = u.shape
    f64 = lambda x: torch.full((ncol,), x, dtype=torch.float64)
    res = tm.my25_turb(cfg, 600.0, f64(1.0), ph, pf, theta, u, v, zh, zf, f64(0.05),
                       torch.zeros((ncol, L + 1), dtype=torch.float64), u_star=f64(ustar),
                       iters=iters)
    return cfg, res


def test_surface_tke_bc():
    tke = tm.tke_surf(tm.MY25Config(), torch.zeros((2, 11), dtype=torch.float64),
                      torch.full((2,), 0.4, dtype=torch.float64))
    np.testing.assert_allclose(tke[..., -1].numpy(), 0.5 * 16.0 ** (2.0 / 3.0) * 0.16,
                               rtol=1e-6)


def test_neutral_shear_generates_turbulence():
    cfg, res = port_run()
    tke, akm = res.tke.numpy(), res.akm.numpy()
    assert tke[0, -1] > 0.5 and tke[0, -3] > 1e-3
    assert akm.max() > 1.0 and np.all(akm >= 0.0) and np.all(akm <= cfg.akmax)
    assert np.all(np.isfinite(tke))


def test_stable_stratification_suppresses_mixing():
    _, neutral = port_run(stable=False)
    _, stable = port_run(stable=True)
    assert float(stable.tke[:, 1:-1].sum()) < 0.5 * float(neutral.tke[:, 1:-1].sum())


def test_tke_bounds_respected():
    cfg, res = port_run(ustar=3.0, shear=3.0e-2)
    assert float(res.tke.max()) <= cfg.tkemax + 1e-9
    assert float(res.tke.min()) >= cfg.tkemin - 1e-12


def test_akmin_floor_near_surface():
    cfg = tm.MY25Config(akmin_land=5.0)
    ph, pf, theta, u, v, zh, zf = map(T, make_bl(stable=True, shear=0.0))
    ncol, L = u.shape
    f64 = lambda x: torch.full((ncol,), x, dtype=torch.float64)
    res = tm.my25_turb(cfg, 600.0, f64(1.0), ph, pf, theta, u, v, zh, zf, f64(0.05),
                       torch.zeros((ncol, L + 1), dtype=torch.float64), u_star=f64(0.01),
                       iters=3)
    assert bool((res.akm[:, -cfg.nk_lim:] >= 5.0 - 1e-9).all())
