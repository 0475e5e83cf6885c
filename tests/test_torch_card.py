"""isca_tpu_torch on a CUDA card: the sw_flux kernel against its plain
PyTorch version, the wrapper's input checks, and the column model's use of
the kernel. Every test here needs a CUDA device and skips without one.

This file imports torch, numpy and isca_tpu_torch only, so it runs where JAX
is absent (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from isca_tpu_torch.convert import column_state_from_numpy, column_state_to_numpy
from isca_tpu_torch.models import column as tcol
from isca_tpu_torch.physics import rrtmg_sw as P
from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig
from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the sw_flux kernel has no CPU mode")


def solve_inputs(cloudy, batch, L, dtype, seed=7):
    """Random solve inputs as tests/test_rrtmg_sw.py TestPallasSolver._inputs."""
    rng = np.random.default_rng(seed)
    G = 112
    c = lambda x: torch.as_tensor(np.asarray(x, dtype), device="cuda")
    tau = rng.gamma(1.5, 0.08, batch + (L, G))
    args = [c(tau), c(rng.uniform(0.0, 1.0, batch + (L, G))),
            c(rng.uniform(0.0, 0.8, batch + (L, G))),
            c(rng.uniform(0.05, 1.0, batch + (1, 1))),
            c(rng.uniform(0.05, 0.6, batch + (G,))),
            c(rng.uniform(0.05, 0.6, batch + (G,))),
            c(rng.uniform(0.0, 12.0, batch + (G,)))]
    cloud = None
    if cloudy:
        cloud = (c(tau + rng.gamma(2.0, 2.0, batch + (L, G))),
                 c(rng.uniform(0.3, 1.0, batch + (L, G))),
                 c(rng.uniform(0.0, 0.9, batch + (L, G))),
                 c(rng.uniform(0.0, 1.0, batch + (L, G))))
    return args, cloud


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch,L", [((37,), 25), ((3, 5), 64), ((1,), 1)])
def test_sw_flux_kernel_matches_plain(cloudy, dtype, batch, L):
    args, cloud = solve_inputs(cloudy, batch, L, dtype)
    before = P.sw_flux_solve.launches
    out = P.sw_flux_solve(*args, cloud=cloud)
    torch.cuda.synchronize()
    assert P.sw_flux_solve.launches == before + 1
    ref = P.sw_flux_solve_reference(*args, cloud=cloud)
    scale = float(ref[0].abs().max())
    # float32: the JAX test's tolerance for the fused solve; float64: the
    # same arithmetic with reassociated g-sums
    rtol, atol = (5e-4, 1e-4 * scale) if dtype == np.float32 else (1e-10, 1e-12 * scale)
    for a, b in zip(out, ref):
        assert a.shape == batch + (L + 1,) and a.dtype == b.dtype
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol, atol=atol)


def test_sw_flux_kernel_rejects_bad_inputs():
    args, _ = solve_inputs(False, (4,), 6, np.float32)
    cases = {
        "not contiguous": (4, args[4].t().contiguous().t()),
        "expected": (1, args[1].double()),
        "shape": (6, args[6][..., :100].contiguous()),
    }
    for match, (i, bad) in cases.items():
        bad_args = list(args)
        bad_args[i] = bad
        with pytest.raises(ValueError, match=match):
            P.sw_flux_solve(*bad_args)
    long_args, _ = solve_inputs(False, (2,), P.SW_FLUX_MAX_L + 1, np.float32)
    with pytest.raises(ValueError, match="limits"):
        P.sw_flux_solve(*long_args)
    with pytest.raises(TypeError, match="dtype"):
        P.sw_flux_solve(*(a.half() for a in args))


def test_column_run_on_card_launches_kernel_each_step():
    cfg = tcol.ColumnConfig(nlat=4, nlon=8, num_levels=25, dt=600.0, lat_deg=30.0,
                            physics=MoistPhysicsConfig(
                                radiation_scheme="rrtm",
                                rrtm=RRTMConfig(lw_scheme="grey", o3_mmr=1e-6)))
    gpu, cpu = tcol.ColumnModel(cfg), tcol.ColumnModel(cfg, device="cpu")
    d = column_state_to_numpy(cpu.initial_state())
    rng = np.random.default_rng(3)
    dT = rng.uniform(-5.0, 5.0, d["t_prev"].shape).astype(np.float32)
    d["t_prev"], d["t_curr"] = d["t_prev"] + dT, d["t_curr"] + dT
    d["time_seconds"] = np.float32(43200.0)
    before = P.sw_flux_solve.launches
    out = column_state_to_numpy(gpu.run(column_state_from_numpy(d), 3))
    assert P.sw_flux_solve.launches == before + 3
    ref = column_state_to_numpy(cpu.run(column_state_from_numpy(d, device="cpu"), 3))
    # float32 card against float32 CPU, with chip_smoke.py's tolerances (the
    # float32 top level is ill-conditioned; see there)
    np.testing.assert_allclose(out["t_curr"][..., 1:], ref["t_curr"][..., 1:], rtol=0, atol=2e-3)
    np.testing.assert_allclose(out["t_curr"][..., 0], ref["t_curr"][..., 0], rtol=0, atol=5e-2)
    np.testing.assert_allclose(out["t_surf"], ref["t_surf"], rtol=0, atol=1e-3)
