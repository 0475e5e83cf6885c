"""isca_tpu_torch RRTMG-SW against isca_tpu: setcoef, taumol, the two-stream
and adding sweeps, the fused flux solve and the whole RRTMGSw driver.

On the CPU `sw_flux_solve` runs its plain PyTorch version; the CUDA kernel
(csrc/sw_flux.cu) is held against that version by tests/test_torch_card.py
and by chip_smoke.py on the card.

Tolerances: rtol 1e-10 at float64 against isca_tpu's jnp path (the same
arithmetic; the one-hot table matmuls and the g-sums only reassociate), and
the JAX test's own float32 tolerance, rtol 5e-4 and atol 1e-4 x max|swd|,
against the Pallas kernel in interpret mode (tests/test_rrtmg_sw.py).
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.physics import rrtmg_sw as J
from isca_tpu_torch.physics import rrtmg_sw as P

GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / "rrtmg_sw_mls.json"
RTOL = 1e-10


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, rtol=RTOL, atol=0.0, msg=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def mls_profile(L=40, ncol=2, ps=1.0e5, t_sfc=288.0, rh=0.4):
    """Top-down (ncol, L) MLS-like columns with a stratospheric ozone bump,
    as tests/test_rrtmg_sw.py make_profile builds them."""
    p_half = np.linspace(20.0, ps, L + 1)
    p_full = 0.5 * (p_half[:-1] + p_half[1:])
    z = 7500.0 * np.log(ps / p_full)
    t = np.maximum(t_sfc - 6.5e-3 * z, 216.0)
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(rh * 0.622 * es / p_full, 0.02)
    o3 = 1.5e-5 * np.exp(-((np.log(p_full) - np.log(2000.0)) / 0.8) ** 2) + 1e-8
    tile = lambda a: np.broadcast_to(a, (ncol, a.shape[-1])).copy()
    return tile(p_half), tile(p_full), tile(t), tile(q), tile(o3)


def solve_inputs(cloudy, batch=(5, 3), L=9, dtype=np.float64, seed=7):
    """Random solve inputs as tests/test_rrtmg_sw.py TestPallasSolver._inputs."""
    rng = np.random.default_rng(seed)
    G = 112
    c = lambda x: np.asarray(x, dtype)
    tau = c(rng.gamma(1.5, 0.08, batch + (L, G)))
    args = [tau, c(rng.uniform(0.0, 1.0, batch + (L, G))),
            c(rng.uniform(0.0, 0.8, batch + (L, G))),
            c(rng.uniform(0.05, 1.0, batch + (1, 1))),
            c(rng.uniform(0.05, 0.6, batch + (G,))),
            c(rng.uniform(0.05, 0.6, batch + (G,))),
            c(rng.uniform(0.0, 12.0, batch + (G,)))]
    cloud = None
    if cloudy:
        cloud = [c(tau + rng.gamma(2.0, 2.0, batch + (L, G))),
                 c(rng.uniform(0.3, 1.0, batch + (L, G))),
                 c(rng.uniform(0.0, 0.9, batch + (L, G))),
                 c(rng.uniform(0.0, 1.0, batch + (L, G)))]
    return args, cloud


def _bottom_up_inputs():
    """setcoef inputs as RRTMGSw builds them from the MLS profile."""
    ph, pf, t, q, o3 = mls_profile()
    flip = lambda a: a[..., ::-1].copy()
    h2o = flip(q / (1.0 - q)) * (J.AMD / J.AMW)
    pz = flip(ph) * 1e-2
    amm = (1.0 - h2o) * J.AMD + h2o * J.AMW
    coldry = ((pz[..., :-1] - pz[..., 1:]) * 1.0e3 * J.AVOGAD
              / (1.0e2 * J.GRAV_CGS * amm * (1.0 + h2o)))
    wkl = {"h2o": h2o * coldry, "co2": 300e-6 * coldry,
           "o3": flip(o3) * (J.AMD / 47.9982) * coldry, "n2o": 0.0 * coldry,
           "ch4": 1.8e-6 * coldry, "o2": 0.209488 * coldry}
    return flip(pf) * 1e-2, flip(t), wkl, coldry


@functools.cache
def _setcoef_taumol_both():
    """(isca_tpu's setcoef and taumol results, the port's) on the MLS columns."""
    pavel, tavel, wkl, coldry = _bottom_up_inputs()
    jt, pt = J._Tables(), P._Tables("cpu")

    @jax.jit
    def jax_side(pavel, tavel, wkl, coldry):
        c = J.setcoef_sw(pavel, tavel, wkl, coldry, jt.t["preflog"], jt.t["tref"])
        return c, J.taumol_sw(c, jt)

    cj, tj = jax_side(jnp.asarray(pavel), jnp.asarray(tavel),
                      {k: jnp.asarray(v) for k, v in wkl.items()}, jnp.asarray(coldry))
    cp = P.setcoef_sw(T(pavel), T(tavel), {k: T(v) for k, v in wkl.items()}, T(coldry),
                      pt.t["preflog"], pt.t["tref"])
    return cj, tj, cp, P.taumol_sw(cp, pt)


def test_setcoef_matches():
    cj, _, cp, _ = _setcoef_taumol_both()
    for name in cp._fields:
        a, b = getattr(cp, name), getattr(cj, name)
        if name == "col":
            for k in b:
                close(a[k], b[k], msg=k)
        elif a.dtype in (torch.bool, torch.int64):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            close(a, b, msg=name)


def test_taumol_matches():
    _, tj, _, tp = _setcoef_taumol_both()
    for a, b, name in zip(tp, tj, ("taug", "taur", "sfluxzen")):
        close(a, b, msg=name)


@pytest.mark.parametrize("w0_max", [0.99, 1.0])
def test_reftra_matches(w0_max):
    rng = np.random.default_rng(11)
    n = 4000
    tau = rng.gamma(0.8, 2.0, n)
    w0 = rng.uniform(0.0, w0_max, n)
    w0[::5] = w0_max                       # conservative branch where w0 = 1
    g = rng.uniform(0.0, 0.95, n)
    mu0 = rng.uniform(0.05, 1.0, n)
    for a, b, name in zip(P.reftra_sw(T(tau), T(w0), T(g), T(mu0)),
                          J.reftra_sw(*map(jnp.asarray, (tau, w0, g, mu0))),
                          ("ref", "refd", "tra", "trad")):
        # exp(+-40) products cancel in the non-conservative branch: the
        # difference is absolute, at 1e-12 of the unit-bounded results
        close(a, b, rtol=RTOL, atol=1e-12, msg=name)


def test_vrtqdr_matches():
    args, _ = solve_inputs(False)
    tau, w0, g, mu0, adir, adif, _ = args
    ts, ws, gs = J._delta_scale(*map(jnp.asarray, (tau, w0, g)))
    props = J.reftra_sw(ts, ws, gs, jnp.asarray(mu0))
    dbt = jnp.exp(-jnp.minimum(ts / jnp.asarray(mu0), 500.0))
    tdbt = jnp.cumprod(jnp.concatenate([jnp.ones_like(dbt[..., :1, :]), dbt], -2), -2)
    ref = jax.jit(J.vrtqdr_sw)(*props, dbt, tdbt, jnp.asarray(adir), jnp.asarray(adif))
    out = P.vrtqdr_sw(*(T(np.asarray(a)) for a in (*props, dbt, tdbt)), T(adir), T(adif))
    for a, b, name in zip(out, ref, ("fd", "fu")):
        close(a, b, msg=name)


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("batch,L", [((5, 3), 9), ((7,), 5)])
def test_sw_flux_solve_matches_jnp_path(cloudy, batch, L):
    """float64: the plain version against isca_tpu's default jnp path."""
    args, cloud = solve_inputs(cloudy, batch, L)
    ref = J.sw_flux_solve(*map(jnp.asarray, args),
                          cloud=None if cloud is None else tuple(map(jnp.asarray, cloud)),
                          force_jnp=True)
    before = P.sw_flux_solve.launches
    out = P.sw_flux_solve(*map(T, args), cloud=None if cloud is None else tuple(map(T, cloud)))
    assert P.sw_flux_solve.launches == before     # CPU tensors launch no kernel
    for a, b, name in zip(out, ref, ("swd", "swu", "dird")):
        assert a.shape == batch + (L + 1,)
        close(a, b, msg=name)


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("batch,L", [((5, 3), 9), ((7,), 5)])
def test_sw_flux_solve_matches_pallas_interpret(cloudy, batch, L):
    """float32: the plain version against the Pallas TPU kernel run in
    interpret mode, at the JAX test's own tolerance."""
    args, cloud = solve_inputs(cloudy, batch, L, dtype=np.float32)
    ref = J.sw_flux_solve(*map(jnp.asarray, args),
                          cloud=None if cloud is None else tuple(map(jnp.asarray, cloud)),
                          interpret=True)
    out = P.sw_flux_solve(*map(T, args), cloud=None if cloud is None else tuple(map(T, cloud)))
    scale = float(np.abs(np.asarray(ref[0])).max())
    for a, b, name in zip(out, ref, ("swd", "swu", "dird")):
        assert a.dtype == torch.float32
        close(a, b, rtol=5e-4, atol=1e-4 * scale, msg=name)


def test_sw_flux_solve_rejects_other_devices():
    args, _ = solve_inputs(False, (2,), 3)
    meta = [T(a).to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        P.sw_flux_solve(*meta)


@pytest.mark.parametrize("G", [1, 33, 112, 128, 256, 1000])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_sw_flux_plan_fits_every_shape(itemsize, G):
    """The kernel's launch plan for every L up to 160 and at the largest L
    it takes: a block fits in the card's shared memory, its chunks cover the
    g-points exactly with none empty, and its threads are whole warps that
    cover a chunk's sweeps (csrc/sw_flux.cu check_plan; the threads loop
    over the L+1 output levels)."""
    max_l = P.sw_flux_max_levels(itemsize)
    for L in [*range(1, 161), max_l]:
        threads, chunks, smem = plan = P.sw_flux_plan(L, G, itemsize)
        gc = -(-G // chunks)
        assert (chunks - 1) * gc < G <= chunks * gc, plan
        assert smem == P.sw_flux_smem_bytes(L, gc, itemsize) <= 232448, plan
        assert threads % 32 == 0 and threads >= gc, plan
    # the main path's float32 T42L25 shape in its preferred chunks; float64
    # at L = 64 needs 2 chunks of 56, or 3 of 43 at G = 128
    assert P.sw_flux_plan(25, 112, 4).chunks == P.SW_FLUX_SHALLOW_F32_CHUNKS
    assert P.sw_flux_plan(64, 112, 8).chunks == 2
    assert P.sw_flux_plan(64, 128, 8).chunks == 3
    assert max_l == (5810 if itemsize == 4 else 2905)
    for L, G_bad in ((0, G), (max_l + 1, G), (1, 0)):
        with pytest.raises(ValueError, match="limits"):
            P.sw_flux_plan(L, G_bad, itemsize)


def _rrtmg_both(coszen=0.7, albedo=0.1, cloudy=False):
    ph, pf, t, q, o3 = mls_profile()
    ncol, L = t.shape
    kw_np = {}
    if cloudy:
        rng = np.random.default_rng(3)
        cf = np.zeros((ncol, L))
        cf[:, 26:33] = rng.uniform(0.3, 1.0, (ncol, 7))
        kw_np = dict(cldfrac=cf, taucld=np.where(cf[..., None] > 0, 8.0, 0.0) * np.ones(14),
                     ssacld=np.full((ncol, L, 14), 0.9994), asmcld=np.full((ncol, L, 14), 0.85))
    cz, alb = np.full(ncol, coszen), np.full(ncol, albedo)
    ref = jax.jit(J.RRTMGSw(J.RRTMGSwConfig()))(
        *map(jnp.asarray, (ph, pf, t, q, o3, cz, alb, alb)),
        **{k: jnp.asarray(v) for k, v in kw_np.items()})
    out = P.RRTMGSw(P.RRTMGSwConfig(), device="cpu")(
        *map(T, (ph, pf, t, q, o3, cz, alb, alb)), **{k: T(v) for k, v in kw_np.items()})
    return out, ref


@pytest.mark.parametrize("cloudy", [False, True])
def test_rrtmg_sw_matches(cloudy):
    out, ref = _rrtmg_both(cloudy=cloudy)
    for name in ref._fields:
        # heating rates divide flux differences by thin-layer dp: absolute
        # tolerance at 1e-12 of the largest heating rate
        atol = 1e-12 * float(np.abs(np.asarray(ref.swhr)).max()) if name == "swhr" else 0.0
        close(getattr(out, name), getattr(ref, name), atol=atol, msg=name)


def test_rrtmg_sw_mls_golden():
    """The frozen MLS flux set of tests/test_rrtmg_sw.py, at its tolerances."""
    gold = json.loads(GOLDEN.read_text())
    out, _ = _rrtmg_both()
    close(out.swdflx[0], gold["swdflx"], rtol=2e-4, atol=5e-3)
    close(out.swuflx[0], gold["swuflx"], rtol=2e-4, atol=5e-3)
    close(out.swhr[0], gold["swhr"], rtol=5e-4, atol=1e-4)
