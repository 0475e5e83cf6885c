"""isca_tpu_torch on a CUDA card: the sw_flux kernel against its plain
PyTorch version, the wrapper's input checks, the column model's use of the
kernel, the Held-Suarez model and its extended diagnostics on the card
against the CPU, the run harness (Experiment, restarts) on the card, and the
grey-moist Frierson GCM (T42L25 against the CPU, its RRTM variant's use of
the kernel, its restarts, a CO2 series built on the card), the stirring's threefry draws (bit for bit
against the CPU) and a stirred barotropic step.
Every test here needs a CUDA device and skips without one.

This file imports torch, numpy and isca_tpu_torch only, so it runs where JAX
is absent (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from isca_tpu_torch.convert import column_state_from_numpy, column_state_to_numpy
from isca_tpu_torch.dycore.primitive import PrimitiveConfig
from isca_tpu_torch.experiment import Experiment
from isca_tpu_torch.io.diag_manager import DiagTable
from isca_tpu_torch.io.restart import load_restart, save_restart
from isca_tpu_torch.models import column as tcol
from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
from isca_tpu_torch.physics import rrtmg_sw as P
from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig
from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig
from isca_tpu_torch.utils.tree import flatten_with_paths

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the sw_flux kernel has no CPU mode")


def solve_inputs(cloudy, batch, L, dtype, seed=7, G=112):
    """Random solve inputs as tests/test_rrtmg_sw.py TestPallasSolver._inputs."""
    rng = np.random.default_rng(seed)
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


def check_kernel_matches_plain(cloudy, dtype, batch, L, G=112):
    args, cloud = solve_inputs(cloudy, batch, L, dtype, G=G)
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


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch,L", [((37,), 25), ((3, 5), 64), ((1,), 1)])
def test_sw_flux_kernel_matches_plain(cloudy, dtype, batch, L):
    check_kernel_matches_plain(cloudy, dtype, batch, L)


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("dtype,batch,L,G", [
    (np.float32, (9,), 25, 33),      # a ragged last round of phase 1
    (np.float64, (9,), 25, 33),
    (np.float32, (5,), 64, 128),     # full chunks: 2 of 64 at float32
    (np.float64, (5,), 64, 128),     # 3 chunks of 43, 43, 42 at float64
    (np.float32, (11,), 40, 112),    # deeper than the main path's L = 25
])
def test_sw_flux_kernel_matches_plain_other_widths(cloudy, dtype, batch, L, G):
    check_kernel_matches_plain(cloudy, dtype, batch, L, G)


@pytest.mark.parametrize("dtype,L,G", [(torch.float32, 25, 112), (torch.float64, 64, 128)])
def test_sw_flux_plan_is_resident(dtype, L, G):
    for cloudy in (False, True):
        assert P.sw_flux_blocks_per_sm(L, G, dtype, cloudy) >= 1


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


def test_held_suarez_on_card_matches_cpu():
    """T21L8 float32, 3 steps from cold start on the card and on the CPU:
    each field within 3x the CPU's own float32-versus-float64 difference
    over the same steps (chip_smoke.py's dycore rule at T85L25)."""
    def fields(dtype, device):
        cfg = HeldSuarezConfig(core=PrimitiveConfig(resolution="T21", num_levels=8,
                                                    dt=1200.0, dtype=dtype))
        model = HeldSuarezModel(cfg, device=device)
        state = model.run(model.initial_state(), 3)
        assert state.tg.curr.device.type == torch.device(device).type
        return {k: v.cpu().numpy().astype(np.float64) for k, v in model.diag_fields(state).items()}

    gpu, cpu32, cpu64 = (fields(torch.float32, "cuda"), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    for k in ("ucomp", "vcomp", "temp", "ps", "vor", "div", "omega"):
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


def hs_t21(dtype=torch.float32, device=None):
    return HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(
        resolution="T21", num_levels=8, dt=1800.0, dtype=dtype)), device=device)


def assert_states_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y), p


def test_held_suarez_experiment_on_card_equals_direct_run(tmp_path):
    """Two chained 1-day segments with daily averages, through a restart,
    against one direct 2-day run on the card: equal on every leaf."""
    table = DiagTable().add_file("atmos_daily", 86400)
    for f in ("temp", "ps"):
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp = Experiment("card", hs_t21(), table, datadir=str(tmp_path))
    exp.run(1, days=1)
    chained = exp.run(2, days=1)
    assert chained.tg.curr.is_cuda
    model = hs_t21()
    assert_states_equal(chained, model.run(model.initial_state(), 96))
    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "card" / "run0002" / "atmos_daily.nc"), mmap=False) as nc:
        temp = np.array(nc.variables["temp"][:])
    assert temp.shape == (1, 8, 32, 64) and np.isfinite(temp).all()


def test_restart_round_trip_on_card(tmp_path):
    model = hs_t21()
    state = model.run(model.initial_state(), 3)
    path = str(tmp_path / "res.npz")
    save_restart(path, state)
    back = load_restart(path, model.initial_state())
    assert back.vors.curr.dtype == torch.complex64 and back.tg.curr.dtype == torch.float32
    assert_states_equal(back, state)


def test_spectral_diagnostics_on_card_matches_cpu():
    """diag_fields(extended=True) after 3 steps: each field within 3x the
    CPU's own float32-versus-float64 difference (the HS card test's rule)."""
    def fields(dtype, device):
        model = hs_t21(dtype, device)
        state = model.run(model.initial_state(), 3)
        return {k: v.cpu().numpy().astype(np.float64)
                for k, v in model.diag_fields(state, extended=True).items()}

    gpu, cpu32, cpu64 = (fields(torch.float32, "cuda"), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    assert sorted(gpu) == sorted(cpu64)
    for k in cpu64:
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


# ---------------------------------------------------------------------------
# the grey-moist Frierson GCM
# ---------------------------------------------------------------------------

FRIERSON_FIELDS = ("ps", "ucomp", "vcomp", "temp", "vor", "div", "omega", "sphum", "t_surf")


def frierson(dtype=torch.float32, device=None, small=False, **physics):
    """frierson_test_case_config(): T42L25 as published, or cut to T21L8
    (every third level of the Frierson sigma ladder)."""
    import dataclasses

    from isca_tpu_torch.models import moist

    cfg = moist.frierson_test_case_config(dtype=dtype)
    if small:
        bk = tuple(moist.FRIERSON_BK[i] for i in (0, 3, 6, 9, 12, 15, 18, 21, 25))
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(
            cfg.core, resolution="T21", num_levels=8,
            vert_coord_kwargs=(("bk", bk), ("pk", (0.0,) * 9))))
    if physics:
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, **physics))
    return moist.GreyMoistModel(cfg, device=device)


def test_frierson_T42L25_on_card_matches_cpu():
    """3 float32 steps from cold start on the card and on the CPU: each field
    within 3x the CPU's own float32-versus-float64 difference (chip_smoke.py's
    moist rule)."""
    def fields(dtype, device):
        model = frierson(dtype, device)
        state = model.run(model.initial_state(), 3)
        assert state.dyn.tg.curr.device.type == torch.device(device).type
        return {k: v.cpu().numpy().astype(np.float64)
                for k, v in model.diag_fields(state).items() if k in FRIERSON_FIELDS}

    gpu, cpu32, cpu64 = (fields(torch.float32, "cuda"), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    for k in FRIERSON_FIELDS:
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


def test_rrtm_grey_gcm_launches_sw_flux_each_step():
    model = frierson(small=True, radiation_scheme="rrtm",
                     rrtm=RRTMConfig(lw_scheme="grey"))
    before = P.sw_flux_solve.launches
    state = model.run(model.initial_state(), 3)
    torch.cuda.synchronize()
    assert P.sw_flux_solve.launches == before + 3
    assert bool(torch.isfinite(state.dyn.tg.curr).all())


def test_frierson_restart_round_trip_on_card(tmp_path):
    """A Frierson state through a restart file is equal on every leaf, and a
    step from it equals a step from the state itself."""
    model = frierson(small=True)
    state = model.run(model.initial_state(), 3)
    path = str(tmp_path / "res.npz")
    save_restart(path, state)
    back = load_restart(path, model.initial_state())
    assert back.time_seconds.dtype == torch.float32 and back.rad_cache.age.dtype == torch.int32
    assert_states_equal(back, state)
    assert_states_equal(model.step(back), model.step(state))


def test_frierson_co2_series_on_card_matches_cpu():
    """A CO2 series built with the loader's default device lies on the card
    beside the model; 3 Byrne-radiation steps with it on the card agree with
    the CPU by the 3x float32-versus-float64 rule."""
    from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig
    from isca_tpu_torch.utils.time_interp import monthly_climatology

    co2 = np.linspace(300.0, 600.0, 12)

    def fields(dtype, device):
        model = frierson(dtype, device, small=True,
                         radiation=TwoStreamConfig(rad_scheme="byrne"))
        series = monthly_climatology(co2, dtype=dtype, device=device)
        assert series.times.device == model.core.T.lats.device
        model.physics.co2_series = series
        state = model.run(model.initial_state(), 3)
        return {k: v.cpu().numpy().astype(np.float64)
                for k, v in model.diag_fields(state).items() if k in FRIERSON_FIELDS}

    gpu, cpu32, cpu64 = (fields(torch.float32, None), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    for k in FRIERSON_FIELDS:
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_threefry_on_card_equals_cpu(seed):
    """The stirring's key chain and draws on the card are the CPU's, bit for
    bit, at float32 and float64 on T85's spectral shape."""
    from isca_tpu_torch.utils import threefry

    kg, kc = threefry.prng_key(seed, "cuda"), threefry.prng_key(seed, "cpu")
    assert kg.dtype == torch.uint32 and kg.device.type == "cuda"
    for _ in range(10):
        pg, pc = threefry.split(kg), threefry.split(kc)
        assert torch.equal(pg.cpu(), pc)
        for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
            a = threefry.uniform(pg[1], (86, 87, 2), dtype, -1.0, 1.0)
            assert a.device.type == "cuda"
            b = threefry.uniform(pc[1], (86, 87, 2), dtype, -1.0, 1.0)
            assert torch.equal(a.cpu().view(bits), b.view(bits))
        kg, kc = pg[0], pc[0]


def test_barotropic_step_on_card():
    """One stirred barotropic step at T85 on the card: finite, the key
    advanced as on the CPU, the stirring state nonzero."""
    from isca_tpu_torch.models.barotropic import BarotropicConfig, BarotropicModel

    cfg = BarotropicConfig(resolution="T85", dt=1200.0, initial_zonal_wind="zero",
                           stirring_amplitude=3.0e-11, damping_order=2,
                           damping_coeff_r=1.929e-6)
    gpu = BarotropicModel(cfg)
    state = gpu.step(gpu.initial_state(), first=True)
    cpu = BarotropicModel(cfg, device="cpu")
    ref = cpu.step(cpu.initial_state(), first=True)
    assert state.vors.curr.device.type == "cuda" and state.rng.dtype == torch.uint32
    assert torch.equal(state.rng.cpu(), ref.rng)
    assert bool(torch.isfinite(state.vorg.curr).all())
    assert float(state.s_stir.abs().max()) > 0.0
