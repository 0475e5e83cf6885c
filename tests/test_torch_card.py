"""isca_tpu_torch on a CUDA card: the sw_flux kernel against its plain
PyTorch version, the wrapper's input checks, the column model's use of the
kernel, the Held-Suarez model and its extended diagnostics on the card
against the CPU, the run harness (Experiment, restarts) on the card, and the
grey-moist Frierson GCM (T42L25 against the CPU, its RRTM variant's use of
the kernel, its restarts, a CO2 series built on the card), the stirring's threefry draws (bit for bit
against the CPU) and a stirred barotropic step; RRTMG-LW at T42L25 width
against the CPU at float64, a step of the MiMA test case, and the radiation
substepping decision, which reads no CUDA tensor; a cloudy SOCRATES
aquaplanet step and a simple_clouds step (RRTM with SimCloud) on the card
against the CPU, and McICA's draws on the card bit for bit against the CPU;
each new column scheme (mg_drag, cg_drag, RAS, MY2.5, shallow convection,
the stable BL, EDT, entrain) and each new GCM path (MiMA with its drag and
series, the continents with SSTs and sea ice, RAS and the four
boundary-layer schemes) at T21 on the card against the CPU at float32;
2 gloo ranks sharing the card (HS steps against the card alone, and the
MiMA test case's sw_flux on each rank's band against its plain version),
the native library, and exp/namelists/mima.nml built on the card through
the port's namelist reader; the transform precision modes (the plain split
on the card bit for bit against the CPU's; the tf32_product kernel against
its plain version at every product, both modes, T21 to T213, a ragged
contraction, a mesh rank's tables and a non-contiguous band, a NaN input,
its launch counter and the tensors it refuses; each "high" and "default"
transform product against the CPU's plain version, the cuBLAS TF32 switch
restored after every call, and a "highest" Held-Suarez step bit-equal
before and after a "high" one). Every test here
needs a CUDA device and skips without one.

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
    (np.float32, (9,), 25, 28),      # SOCRATES' synthetic SW spectrum
    (np.float64, (9,), 25, 28),
])
def test_sw_flux_kernel_matches_plain_other_widths(cloudy, dtype, batch, L, G):
    check_kernel_matches_plain(cloudy, dtype, batch, L, G)


@pytest.mark.parametrize("cloudy", [False, True])
@pytest.mark.parametrize("dtype,batch,L,G", [
    (np.float32, (6,), 80, 112),     # two chunks of 56 (one no longer fits)
    (np.float32, (6,), 128, 112),
    (np.float32, (3,), 300, 112),    # L + 1 > 256 threads: the levels loop
    (np.float32, (6,), 25, 256),     # two chunks of 128
    (np.float32, (3,), 25, 1000),    # four chunks of 250
    (np.float64, (4,), 100, 112),    # three chunks of 38
])
def test_sw_flux_kernel_matches_plain_deep_and_wide(cloudy, dtype, batch, L, G):
    """Shapes past the kernel's former limits (L <= 64, G <= 128)."""
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
    long_args, _ = solve_inputs(False, (1,), P.sw_flux_max_levels(4) + 1, np.float32)
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


# ---------------------------------------------------------------------------
# RRTMG-LW, the MiMA GCM and radiation substepping
# ---------------------------------------------------------------------------

LW_FIELDS = ("uflx", "dflx", "hr", "olr", "lw_dn_surf")


def lw_columns(shape=(64, 128), L=25, seed=5):
    """Top-down MLS-like columns (tests/test_rrtmg_lw.py mls_profile) at
    T42L25 width, perturbed per column from a seed: T +-5 K, relative
    humidity 0.1-0.95, surface 290-305 K."""
    rng = np.random.default_rng(seed)
    ps = 1.0e5
    p_half = np.broadcast_to(np.linspace(20.0, ps, L + 1), shape + (L + 1,)).copy()
    p_full = 0.5 * (p_half[..., :-1] + p_half[..., 1:])
    t_sfc = rng.uniform(290.0, 305.0, shape)
    lapse = lambda p: t_sfc[..., None] - 6.5e-3 * 7500.0 * np.log(ps / np.maximum(p, 1.0))
    t = np.maximum(lapse(p_full), 216.0) + rng.uniform(-5.0, 5.0, shape + (L,))
    th = np.maximum(lapse(p_half), 216.0)
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = np.minimum(rng.uniform(0.1, 0.95, shape + (1,)) * 0.622 * es / p_full, 0.02)
    o3 = 1.5e-5 * np.exp(-((np.log(p_full) - np.log(2000.0)) / 0.8) ** 2) + 1e-8
    return p_half, p_full, t, th, t_sfc, q, o3


def test_rrtmg_lw_T42L25_on_card_matches_cpu_float64():
    """One RRTMG-LW call on 64 x 128 columns of 25 levels: on the card at
    float64 within rtol 1e-9 of the CPU's float64 (the same arithmetic,
    reassociated in cuBLAS's products and sums); at float32 as accurate as
    the CPU's float32, within 3x, against the CPU's float64."""
    import warnings

    from isca_tpu_torch.physics.rrtmg_lw import RRTMGLw, RRTMGLwConfig

    args = lw_columns()
    cfg = RRTMGLwConfig(co2vmr=3.0e-4, n2ovmr=3.2e-7, ch4vmr=1.8e-6)

    def run(device, dtype):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            lw = RRTMGLw(cfg, device=device)
        out = lw(*(torch.as_tensor(a, dtype=dtype, device=device) for a in args))
        return {k: getattr(out, k).cpu().numpy().astype(np.float64) for k in LW_FIELDS}

    cpu64, cpu32 = run("cpu", torch.float64), run("cpu", torch.float32)
    gpu64, gpu32 = run("cuda", torch.float64), run("cuda", torch.float32)
    for k in LW_FIELDS:
        scale = np.abs(cpu64[k]).max()
        np.testing.assert_allclose(gpu64[k], cpu64[k], rtol=1e-9, atol=1e-9 * scale, err_msg=k)
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu32[k] - cpu64[k]).max() <= 3.0 * gap, k


def test_mima_gcm_step_on_card():
    """One step of mima_test_case.py at T42L25 on the card: RRTMG-LW selected,
    sw_flux launched once, the radiation age on the host, each field within
    3x the CPU's own float32-versus-float64 difference."""
    import warnings

    from isca_tpu_torch.models.moist import GreyMoistModel, mima_test_case_config

    def fields(dtype, device):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            model = GreyMoistModel(mima_test_case_config(dtype=dtype), device=device)
        assert model.physics.radiation.lw_rrtmg is not None
        before = P.sw_flux_solve.launches
        state, diag = model.step_with_diagnostics(model.initial_state(), first=True)
        if device == "cuda":
            torch.cuda.synchronize()
            assert P.sw_flux_solve.launches == before + 1
            assert state.rad_cache.age.device.type == "cpu" and int(state.rad_cache.age) == 1
        out = {k: v.cpu().numpy().astype(np.float64)
               for k, v in model.diag_fields(state).items() if k in FRIERSON_FIELDS}
        out["olr"] = diag["olr"].cpu().numpy().astype(np.float64)
        return out

    gpu, cpu32, cpu64 = (fields(torch.float32, "cuda"), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    assert np.isfinite(gpu["olr"]).all() and 100.0 < gpu["olr"].mean() < 400.0
    for k in FRIERSON_FIELDS + ("olr",):
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


def test_rad_decision_reads_no_cuda_tensor():
    """The dt_rad decision over 25 steps at MiMA's n_rad = 10, with the
    stored radiation on the card, under sync debug mode "error": it reads
    no CUDA tensor (a read of one raises in this mode)."""
    from isca_tpu_torch.physics.moist_driver import rad_age, rad_due, zero_rad_cache

    cfg = MoistPhysicsConfig(dt_rad=7200.0)
    cache = zero_rad_cache((64, 128), 25, torch.float32, device="cuda")
    assert cache.tdt_rad.is_cuda and cache.age.device.type == "cpu"
    torch.cuda.synchronize()
    due = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(25):
            due.append(rad_due(cfg, 720.0, cache))
            cache = cache._replace(age=rad_age(1) if due[-1] else cache.age + 1)
        with pytest.raises(RuntimeError):
            bool(cache.tdt_rad.sum() > 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [i for i, d in enumerate(due) if d] == [0, 10, 20]


# ---------------------------------------------------------------------------
# clouds and SOCRATES
# ---------------------------------------------------------------------------

def cloudy_gcm_fields(config, dtype, device, launches):
    """One step of a test-case config at T21L25 started moist (0.01 kg/kg:
    SimCloud makes clouds from the first step): the FRIERSON_FIELDS, olr
    and cf. On the card, sw_flux must launch `launches` times."""
    import dataclasses
    import warnings

    from isca_tpu_torch.models.moist import GreyMoistModel

    cfg = dataclasses.replace(config(dtype=dtype, resolution="T21"), initial_sphum=0.01)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        model = GreyMoistModel(cfg, device=device)
    before = P.sw_flux_solve.launches
    state, diag = model.step_with_diagnostics(model.initial_state(), first=True)
    if device == "cuda":
        torch.cuda.synchronize()
        assert P.sw_flux_solve.launches == before + launches
    out = {k: v.cpu().numpy().astype(np.float64)
           for k, v in model.diag_fields(state).items() if k in FRIERSON_FIELDS}
    for k in ("olr", "cf"):
        out[k] = diag[k].cpu().numpy().astype(np.float64)
    return out


@pytest.mark.parametrize("case", ["socrates_cloud", "simple_clouds"])
def test_cloudy_gcm_step_on_card_matches_cpu(case):
    """One cloudy step at T21L25 on the card: SOCRATES with SimCloud (sw_flux
    once, G = 28, the cloud fraction expanded to full shape before the
    kernel; a broadcast one would raise here and not on the CPU) or RRTM with
    SimCloud (sw_flux twice: clear, then total sky); each field within 3x the
    CPU's own float32-versus-float64 difference."""
    from isca_tpu_torch.models import moist

    config, launches = {
        "socrates_cloud": (lambda **kw: moist.socrates_aquaplanet_test_case_config(True, **kw), 1),
        "simple_clouds": (moist.simple_clouds_test_case_config, 2)}[case]
    gpu, cpu32, cpu64 = (cloudy_gcm_fields(config, torch.float32, "cuda", launches),
                         cloudy_gcm_fields(config, torch.float32, "cpu", launches),
                         cloudy_gcm_fields(config, torch.float64, "cpu", launches))
    assert gpu["cf"].max() == 1.0 and np.isfinite(gpu["olr"]).all()
    for k in FRIERSON_FIELDS + ("olr", "cf"):
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mcica_draws_on_card_equal_cpu(dtype):
    from isca_tpu_torch.physics.mcica import mcica_subcol
    from isca_tpu_torch.utils.threefry import prng_key

    rng = np.random.default_rng(3)
    cf = np.where(rng.uniform(0, 1, (64, 25)) > 0.4, rng.uniform(0, 1, (64, 25)), 0.0)
    args = (cf, cf * 50.0, cf * 20.0)
    out = {d: mcica_subcol(prng_key(9, device=d), *(torch.as_tensor(a, dtype=dtype, device=d)
                                                     for a in args), 140)
           for d in ("cpu", "cuda")}
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the gravity-wave drags, the series, RAS and the boundary-layer schemes
# ---------------------------------------------------------------------------

def sounding_columns(ncol=6, L=25, seed=4):
    """Conditionally unstable moist columns (numpy float64, level-last,
    top-down): a 6.8 K/km lapse rate from 296-304 K, 85% relative humidity
    falling off above 3 km, noisy winds, hydrostatic heights."""
    rng = np.random.default_rng(seed)
    p_half = np.linspace(20.0e2, 1.0e5, L + 1) * np.ones((ncol, 1))
    p_full = 0.5 * (p_half[:, 1:] + p_half[:, :-1])
    z_full = 7600.0 * np.log(1.0e5 / p_full)
    z_half = 7600.0 * np.log(1.0e5 / p_half)
    t = np.maximum(rng.uniform(296.0, 304.0, (ncol, 1)) - 6.8e-3 * z_full, 200.0)
    es = 610.78 * np.exp(17.27 * (t - 273.15) / (t - 35.85))
    q = 0.85 * 0.622 * es / p_full * np.exp(-np.maximum(z_full - 3000.0, 0.0) / 3000.0)
    return dict(t=t, q=q, u=rng.normal(5.0, 5.0, t.shape), v=rng.normal(0.0, 5.0, t.shape),
                p_full=p_full, p_half=p_half, z_full=z_full, z_half=z_half,
                lat=np.deg2rad(rng.uniform(-70.0, 70.0, ncol)))


def scheme_outputs(name, dtype, device):
    """One call of a new column scheme on `device` at `dtype`, its named
    outputs as float64 numpy."""
    from isca_tpu_torch.physics import bl_schemes, edt, entrain, gravity_wave_drag as gwd
    from isca_tpu_torch.physics import my25_turb, ras
    from isca_tpu_torch.physics.sat_vapor_pres import SatVaporPres

    c = sounding_columns()
    on = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    a = {k: on(v) for k, v in c.items()}
    ncol, L = c["t"].shape
    full = lambda x: torch.full((ncol,), x, dtype=dtype, device=device)
    svp = SatVaporPres(do_simple=True)
    if name == "mg_drag":
        res = gwd.mg_drag(gwd.MgDragConfig(do_conserve_energy=True), 1440.0, a["u"], a["v"],
                          a["t"], a["p_full"], a["p_half"], a["z_full"], a["z_half"],
                          full(400.0))
    elif name == "cg_drag":
        res = gwd.CgDrag(gwd.CgDragConfig(), a["lat"], c["p_full"][0])(
            a["p_full"], a["z_full"], a["t"], a["u"], a["v"])
    elif name == "ras":
        res = ras.RAS(ras.RASConfig(), svp)(1440.0, a["t"], a["q"], a["u"], a["v"],
                                            a["p_full"], a["p_half"], a["z_half"])
    elif name == "my25":
        theta = a["t"] * (1.0e5 / a["p_full"]) ** (2.0 / 7.0)
        tke = on(np.full((ncol, L + 1), 0.2))
        res = my25_turb.my25_turb(my25_turb.MY25Config(), 720.0, full(0.3), a["p_half"],
                                  a["p_full"], theta, a["u"], a["v"], a["z_half"],
                                  a["z_full"], full(0.05), tke, u_star=full(0.4), iters=3)
    elif name == "shallow_conv":
        res = bl_schemes.shallow_conv(bl_schemes.ShallowConvConfig(), svp, a["t"], a["q"],
                                      a["p_full"], a["p_half"])
        res = dict(akhsc=res[0], plcl=res[1])
    elif name == "stable_bl":
        res = bl_schemes.stable_bl_turb(bl_schemes.StableBLConfig(), a["lat"], a["t"], a["q"],
                                        a["u"], a["v"], a["z_full"], a["z_half"], full(0.3),
                                        on(np.linspace(-0.02, 0.02, ncol)))
    else:
        zero = torch.zeros_like(a["t"])
        tdtlw = on(np.where(np.abs(c["z_full"] - 900.0) < 300.0, -5e-4, 0.0))
        qa = on(np.where(np.abs(c["z_full"] - 900.0) < 600.0, 0.8, 0.0))
        args = (a["t"], a["q"], zero, zero, qa, a["u"], a["v"], a["z_full"], a["p_full"],
                a["z_half"], a["p_half"])
        bstar = on(np.linspace(-0.005, 0.02, ncol))
        if name == "edt":
            res = edt.edt(edt.EDTConfig(), tdtlw, full(0.3), bstar, *args)
        else:
            res = entrain.entrain(entrain.EntrainConfig(), tdtlw,
                                  torch.zeros(ncol, dtype=torch.bool, device=device),
                                  full(0.3), bstar, *args, zero + 0.5, zero + 0.5)
    items = res.items() if isinstance(res, dict) else zip(res._fields, res)
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in items}


@pytest.mark.parametrize("name", ["mg_drag", "cg_drag", "ras", "my25", "shallow_conv",
                                  "stable_bl", "edt", "entrain"])
def test_column_scheme_on_card_matches_cpu(name):
    """Each new column scheme on the card at float32 against the same call on
    the CPU: every output within 3x the CPU's own float32-versus-float64
    difference, plus 1e-7 of its largest entry (for an output float32 gets
    exactly); RAS's cloud-base level exactly."""
    gpu, cpu32, cpu64 = (scheme_outputs(name, torch.float32, "cuda"),
                         scheme_outputs(name, torch.float32, "cpu"),
                         scheme_outputs(name, torch.float64, "cpu"))
    assert any(np.abs(v).max() > 0 for v in cpu64.values())
    for k in cpu64:
        if k == "klcl":
            assert np.array_equal(gpu[k], cpu32[k])
            continue
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        err = np.abs(gpu[k] - cpu32[k]).max()
        assert err <= 3.0 * gap + 1e-7 * np.abs(cpu64[k]).max(), (name, k, err, gap)


def new_path_model(path, dtype, device):
    """The new GCM paths cut to T21 (8 levels where the configuration allows
    it), from isca_tpu_torch/models/cases.py."""
    from isca_tpu_torch.models import cases, moist

    l8 = dict(resolution="T21", num_levels=8)
    if path == "mima_gwd":
        return cases.add_mima_series(moist.GreyMoistModel(
            cases.mima_gwd_config(dtype, **l8), device=device))
    if path == "continents_sst":
        return cases.set_continents(moist.GreyMoistModel(
            cases.continents_config(dtype, True, **l8), device=device))
    return moist.GreyMoistModel(cases.ras_bl_config(dtype, path, resolution="T21"),
                                device=device)


@pytest.mark.parametrize("path", ["mima_gwd", "continents_sst", "RAS", "mellor_yamada", "edt",
                                  "entrain", "stable_bl"])
def test_new_gcm_path_on_card_matches_cpu(path):
    """3 steps of each new GCM path at T21 on the card against the CPU at
    float32 (RAS and the stable-BL scheme from cases.convective_start, the
    others from the cold start): each field within 3x the CPU's own
    float32-versus-float64 difference; sw_flux once per step on mima_gwd
    only; the series, the drag tables and MY2.5's TKE on the card."""
    from isca_tpu_torch.models import cases

    def fields(dtype, device):
        model = new_path_model(path, dtype, device)
        start = (cases.convective_start(model) if path in ("RAS", "stable_bl")
                 else model.initial_state())
        before = P.sw_flux_solve.launches
        state = model.run(start, 3)
        if device != "cpu":
            torch.cuda.synchronize()
            assert P.sw_flux_solve.launches - before == (3 if path == "mima_gwd" else 0)
            assert state.tke.is_cuda and state.t_surf.is_cuda
        out = {k: v.cpu().numpy().astype(np.float64)
               for k, v in model.diag_fields(state).items() if k in FRIERSON_FIELDS}
        if path == "mellor_yamada":
            out["tke"] = state.tke.cpu().numpy().astype(np.float64)
        return out

    gpu, cpu32, cpu64 = (fields(torch.float32, None), fields(torch.float32, "cpu"),
                         fields(torch.float64, "cpu"))
    if path == "mellor_yamada":
        assert gpu["tke"].max() > 0.0
    for k in cpu64:
        gap = np.abs(cpu32[k] - cpu64[k]).max()
        assert np.abs(gpu[k] - cpu32[k]).max() <= 3.0 * gap, k


# ---------------------------------------------------------------------------
# the sharded run: 2 gloo ranks on the card, and the native library
# ---------------------------------------------------------------------------

SHARDED_HS = dict(resolution="T42", num_levels=25, dt=600.0, dtype=torch.float64)


def _sharded_hs_rank(rank, outdir):
    """One rank: HS T42L25 float64, 2 steps on a 2-rank mesh on the card;
    rank 0 writes the gathered state, each rank its m rows and block."""
    from isca_tpu_torch.io.restart import save_restart
    from isca_tpu_torch.parallel.mesh import gather_pytree, make_mesh

    mesh = make_mesh(2)
    model = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(mesh=mesh, **SHARDED_HS)))
    T = model.core.T
    state = model.run(model.initial_state(), 2)
    assert state.tg.curr.is_cuda and state.tg.curr.shape == (25, 32, 128)
    whole = gather_pytree(mesh, state, nlat=T.nlat)
    if rank == 0:
        save_restart(f"{outdir}/whole.npz", whole)
    np.savez(f"{outdir}/block{rank}.npz", block=state.ts.curr.cpu().numpy(),
             m_start=T.m_start)


def test_two_gloo_ranks_hs_steps_on_card_match_one_card(tmp_path):
    """2 ranks sharing the card over gloo (its collectives staged through
    the host): 2 HS T42L25 steps at float64 against 2 steps on the card
    alone, every leaf at rtol 1e-9 of its largest entry (the global means
    all_reduce in another order); each rank holds its own m rows."""
    from isca_tpu_torch.parallel.mesh import spawn

    spawn(_sharded_hs_rank, 2, "gloo", str(tmp_path / "init"), args=(str(tmp_path),))
    model = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(pad_m_to=2, **SHARDED_HS)))
    ref = dict(flatten_with_paths(model.run(model.initial_state(), 2)))
    got = load_restart(str(tmp_path / "whole.npz"), model.initial_state())
    for path, a in flatten_with_paths(got):
        b = ref[path]
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-9 * scale, path
    blocks = [np.load(tmp_path / f"block{r}.npz") for r in range(2)]
    assert [int(b["m_start"]) for b in blocks] == [0, 22]
    assert not np.array_equal(blocks[0]["block"], blocks[1]["block"])


def _sharded_mima_rank(rank, outdir):
    """One rank: the MiMA test case at T42L25 float32 on a 2-rank mesh on the
    card, 2 steps; the inputs of each sw_flux call are kept, and the kernel's
    result on them is held against its plain version."""
    import json

    from isca_tpu_torch.models.moist import GreyMoistModel, mima_test_case_config
    from isca_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2)
    model = GreyMoistModel(mima_test_case_config(dtype=torch.float32, mesh=mesh))
    calls, kernel = [], P.sw_flux_solve

    def keep(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    # the wrapper counts on the module's sw_flux_solve, which is `keep` here
    keep.launches = 0
    P.sw_flux_solve = keep
    try:
        model.run(model.initial_state(), 2)
    finally:
        P.sw_flux_solve = kernel
    report = {"launches": keep.launches, "batch": [], "excess": []}
    for args, kwargs in calls:
        out = kernel(*args, **kwargs)
        ref = P.sw_flux_solve_reference(*args, **kwargs)
        scale = float(ref[0].abs().max())
        report["batch"].append(list(args[0].shape))
        report["excess"].append(max(
            float(((a - b).abs() - (1e-4 * scale + 5e-4 * b.abs())).max())
            for a, b in zip(out, ref)))
        report["swd_max"] = scale
    with open(f"{outdir}/mima_rank{rank}.json", "w") as f:
        json.dump(report, f)


def test_two_gloo_ranks_mima_band_sw_flux_matches_plain(tmp_path):
    """2 ranks sharing the card over gloo run the MiMA test case (T42L25,
    float32) on their latitude bands: sw_flux launches once per step on
    each rank, on its 32 x 128 = 4096 columns x 25 levels x 112 g-points,
    and on those inputs agrees with its plain version at the kernel's
    gate (rtol 5e-4, atol 1e-4 x max|swd|)."""
    import json

    from isca_tpu_torch.parallel.mesh import spawn

    spawn(_sharded_mima_rank, 2, "gloo", str(tmp_path / "init"), args=(str(tmp_path),))
    for r in range(2):
        report = json.loads((tmp_path / f"mima_rank{r}.json").read_text())
        assert report["launches"] == 2, report
        assert report["batch"] == [[32, 128, 25, 112]] * 2, report
        assert max(report["excess"]) <= 0.0 and report["swd_max"] > 0.0, report


def test_mima_namelist_builds_on_card(tmp_path):
    """exp/namelists/mima.nml through isca_tpu_torch.namelist builds its
    T42L40 RRTM model on CUDA by default, and a step from cold start
    launches sw_flux once on its 8192 x 40 columns and stays finite."""
    import pathlib

    from isca_tpu_torch.namelist import model_from_namelist, parse_namelist

    nml = pathlib.Path(__file__).resolve().parent.parent / "exp" / "namelists" / "mima.nml"
    model = model_from_namelist(parse_namelist(nml.read_text()))
    c = model.config
    assert model.device.type == "cuda" and model.core.T.grid_shape == (64, 128)
    assert (c.core.num_levels, c.core.dt, c.physics.dt_rad) == (40, 600.0, 7200.0)
    P.sw_flux_solve.launches = 0
    state = model.step(model.initial_state(), first=True)
    torch.cuda.synchronize()
    assert P.sw_flux_solve.launches == 1
    assert bool(torch.isfinite(state.dyn.tg.curr).all()) and state.dyn.tg.curr.is_cuda


def test_native_library_builds_on_the_card_machine():
    from isca_tpu_torch import native

    assert native.native_available()
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.testing.assert_array_equal(native.combine_tiles([full[:2], full[2:]], [0, 2], 6), full)
    assert native.rss_kb() > 1000


# ---- transform precision: "high" (3xTF32) and "default" (one TF32 pass) ----

@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("shape,axis", [((3, 25, 128, 256), -1), ((2, 7, 33, 5, 2), -3),
                                        ((5, 86, 87, 2), -2), ((1,), 0)])
def test_tf32_split_on_the_card_equals_cpu(mode, shape, axis):
    """The plain split (the chip_smoke and card tests' reference; no product
    of the port calls it since the kernel splits as it loads) on a CUDA
    tensor equals the CPU's bit for bit, inf and NaN included."""
    from isca_tpu_torch.spectral import precision as prec

    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32) * 10.0 ** rng.uniform(-30, 30, shape)
    x.reshape(-1)[:3] = [np.inf, np.nan, 3.4028235e38][:x.size]
    xc = torch.as_tensor(x.astype(np.float32), device="cuda")
    out = prec.split(xc, axis, mode)
    assert out.is_cuda
    ref = prec.split_reference(xc.cpu(), axis, mode)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32)[np.isfinite(ref.numpy())],
                                  ref.numpy().view(np.uint32)[np.isfinite(ref.numpy())])
    assert torch.equal(out.cpu().isnan(), ref.isnan())
    with pytest.raises(TypeError, match="float32"):
        prec.split(xc.double(), axis, mode)


TF32_PRODUCTS = {"dft_analysis": ("dft", "dft_ana"), "legendre_analysis": ("analysis", "Pw"),
                 "legendre_synthesis": ("synthesis", "P"), "dft_synthesis": ("dft", "dft_syn")}


def _product_shape(T, name):
    band, M1, N1 = T.lats.shape[0], T.spec_shape[0], T.num_spherical + 1
    return {"dft_analysis": (band, T.nlon), "legendre_analysis": (T.nlat, M1, 2),
            "legendre_synthesis": (M1, N1, 2),
            "dft_synthesis": (band, 2 * (T.num_fourier + 1))}[name]


def _kernel_against_plain(T, name, mode, x):
    """One launch of the tf32_product kernel on x against its plain version
    on the card (the same split, exact FP32 products) within 8 (sqrt(K') u
    |x||table| + K' tiny max|x|): the two differ by the order and rounding
    of their sums (the tensor cores sum 32 terms toward zero, then FP32 to
    nearest) and by the subnormal operands the tensor cores flush."""
    from isca_tpu_torch.spectral import precision as prec

    kind, attr = TF32_PRODUCTS[name]
    plain_t = prec.split_table(getattr(T, attr), prec.TABLE_AXIS[kind], mode)
    before = prec.product.launches
    out = prec.product(x, kind, getattr(T, attr + "_x"), mode)
    torch.cuda.synchronize()
    assert prec.product.launches == before + 1
    ref = prec.product_reference(x, kind, plain_t, mode)
    xs = prec.split(x, prec.DATA_AXIS[kind], mode)
    k = xs.shape[prec.DATA_AXIS[kind]]
    mag = prec.contract(kind, plain_t.abs(), xs.abs()).double()
    bound = 8.0 * (np.sqrt(k) * 2.0 ** -24 * mag + k * 2.0 ** -126 * float(x.abs().max()))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert ((out.double() - ref.double()).abs() <= bound).all(), name
    return out, ref


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("res", ["T21", "T42", "T85", "T170", "T213"])
def test_tf32_product_kernel_against_plain(mode, res):
    from isca_tpu_torch.spectral import transforms as ttr

    T = ttr.make_transforms(res, dtype=torch.float32, precision=mode)
    rng = np.random.default_rng(4)
    for name in TF32_PRODUCTS:
        x = torch.as_tensor(rng.standard_normal((3, 6) + _product_shape(T, name))
                            .astype(np.float32), device="cuda")
        _kernel_against_plain(T, name, mode, x)


@pytest.mark.parametrize("mode", ["high", "default"])
def test_tf32_product_ragged_and_mesh_band(mode):
    """K and n no multiple of 8 (T13 on a 40 x 22 grid: K = 28, 15, 22),
    and rank 1 of 2's tables at T42 with its latitude band cut from the
    whole grid (not contiguous), levels cut from a larger batch, no rows at
    all, and a batch of one field."""
    from isca_tpu_torch.parallel.mesh import Mesh
    from isca_tpu_torch.spectral import precision as prec
    from isca_tpu_torch.spectral import transforms as ttr

    rng = np.random.default_rng(5)
    normal = lambda shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                           device="cuda")
    T = ttr.make_transforms(13, nlon=40, nlat=22, dtype=torch.float32, precision=mode)
    for name in TF32_PRODUCTS:
        _kernel_against_plain(T, name, mode, normal((2, 3) + _product_shape(T, name)))
    mesh = Mesh(group=None, rank=1, size=2, backend="nccl", device=torch.device("cuda"))
    T = ttr.make_transforms("T42", dtype=torch.float32, precision=mode, mesh=mesh)
    band = normal((4, 5, T.nlat, T.nlon))[1:3, :, T.lat_start:T.lat_start + T.nlat // 2]
    assert not band.is_contiguous()
    _kernel_against_plain(T, "dft_analysis", mode, band)
    # levels cut from a larger batch: two strides cannot address the rows,
    # so the wrapper makes x contiguous first
    levels = normal((4, 6, T.lats.shape[0], T.nlon))[:, 1:4]
    _kernel_against_plain(T, "dft_analysis", mode, levels)
    empty = prec.product(normal((0, T.lats.shape[0], T.nlon)), "dft", T.dft_ana_x, mode)
    assert empty.shape == (0, T.lats.shape[0], 2 * (T.num_fourier + 1))
    for name in TF32_PRODUCTS:
        _kernel_against_plain(T, name, mode, normal((1,) + _product_shape(T, name)))


def test_tf32_product_nan_input():
    """A NaN of x reaches every output whose table entries it meets, as in
    the plain version. Where it meets only the zeros of the skipped
    triangle (m = 85 at T85: n < 64 in the analysis, n < 64 in the
    synthesis' contraction), the plain version gives NaN and the kernel 0
    (analysis) or a finite value (synthesis)."""
    from isca_tpu_torch.spectral import precision as prec
    from isca_tpu_torch.spectral import transforms as ttr

    T = ttr.make_transforms("T85", dtype=torch.float32, precision="high")
    M1, N1 = T.num_fourier + 1, T.num_spherical + 1
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, T.nlat, M1, 2)).astype(np.float32)
    x[0, 5, 3, 0] = np.nan                       # m = 3: meets nonzero Pw entries
    x[1, 0, M1 - 1, 1] = np.nan                  # m = 85: n < 85 are zeros
    xc = torch.as_tensor(x, device="cuda")
    out = prec.product(xc, "analysis", T.Pw_x, "high")
    ref = prec.product_reference(xc, "analysis", prec.split_table(T.Pw, 0, "high"), "high")
    assert torch.equal(out[0, 3, 3:, 0].isnan(), ref[0, 3, 3:, 0].isnan())
    assert out[0, 3, 3:, 0].isnan().all()
    assert ref[1, M1 - 1, :64, 1].isnan().all() and (out[1, M1 - 1, :64, 1] == 0).all()
    assert out[1, M1 - 1, 64:, 1].isnan().all()
    # the grid-side products have no skipped zeros: NaN where the plain one has it
    g = rng.standard_normal((2, T.nlat, T.nlon)).astype(np.float32)
    g[1, 7, 9] = np.inf
    gc = torch.as_tensor(g, device="cuda")
    out = prec.product(gc, "dft", T.dft_ana_x, "high")
    ref = prec.product_reference(gc, "dft", prec.split_table(T.dft_ana, 0, "high"), "high")
    assert torch.equal(out.isnan(), ref.isnan()) and out[1, 7].isnan().any()
    s = rng.standard_normal((1, M1, N1, 2)).astype(np.float32)
    s[0, M1 - 1, 0, 0] = np.nan                  # m = 85, n = 0: a skipped tile
    sc = torch.as_tensor(s, device="cuda")
    out = prec.product(sc, "synthesis", T.P_x, "high")
    ref = prec.product_reference(sc, "synthesis", prec.split_table(T.P, 2, "high"), "high")
    assert ref[0, :, M1 - 1, 0].isnan().all() and torch.isfinite(out[0, :, M1 - 1, 0]).all()


def test_tf32_product_takes_only_float32_cuda_tensors():
    """A float64 CUDA tensor raises before the kernel; a CPU tensor runs the
    plain version with split_table's layout and refuses a packed table;
    none of them launches the kernel."""
    from isca_tpu_torch.spectral import precision as prec
    from isca_tpu_torch.spectral import transforms as ttr

    T = ttr.make_transforms("T21", dtype=torch.float32, precision="high")
    Th = ttr.make_transforms("T21", dtype=torch.float32, device="cpu", precision="high")
    x = torch.zeros(2, T.nlat, T.nlon, device="cuda")
    before = prec.product.launches
    with pytest.raises(TypeError, match="float32"):
        prec.product(x.double(), "dft", T.dft_ana_x, "high")
    with pytest.raises(TypeError, match="PackedTable"):
        prec.product(x.cpu(), "dft", T.dft_ana_x, "high")
    with pytest.raises(TypeError, match="PackedTable"):
        prec.product(x, "dft", Th.dft_ana_x.cuda(), "high")
    with pytest.raises(ValueError, match="table"):
        prec.product(x, "dft", T.dft_ana_x, "default")      # packed for "high"
    plain = prec.product(x.cpu(), "dft", Th.dft_ana_x, "high")
    assert plain.device.type == "cpu" and prec.product.launches == before
    prec.product(x, "dft", T.dft_ana_x, "high")
    torch.cuda.synchronize()
    assert prec.product.launches == before + 1


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("res", ["T42", "T85"])
def test_tf32_products_match_plain_version(mode, res):
    """Each transform product (DFT and Legendre, analysis and synthesis) at
    the mode on the card against the plain version of the same mode on the
    CPU: the operands round alike, so the two differ by the order and
    rounding of the FP32 sums, at most 8 (sqrt(K') u |x||table| + K' tiny
    max|x|) per entry (K' terms, u = 2^-24, tiny = 2^-126: the tensor
    cores flush subnormal operands to zero, and the Legendre tables hold
    subnormal values near the poles); the TF32 switch is off after each
    product, and the card's "high" and "default" products differ from its
    exact ones."""
    from isca_tpu_torch.spectral import precision as prec
    from isca_tpu_torch.spectral import transforms as ttr

    Tc = ttr.make_transforms(res, dtype=torch.float32, precision=mode)
    Th = ttr.make_transforms(res, dtype=torch.float32, device="cpu", precision=mode)
    rng = np.random.default_rng(9)
    M1, N1 = Tc.num_fourier + 1, Tc.num_spherical + 1
    cases = {"dft_analysis": ((Tc.nlat, Tc.nlon), "dft", "dft_ana", Tc.nlon),
             "legendre_analysis": ((Tc.nlat, M1, 2), "analysis", "Pw", Tc.nlat),
             "legendre_synthesis": ((M1, N1, 2), "synthesis", "P", N1),
             "dft_synthesis": ((Tc.nlat, 2 * M1), "dft", "dft_syn", 2 * M1)}
    for name, (shape, kind, table, K) in cases.items():
        x = torch.as_tensor(rng.standard_normal((4, 25) + shape).astype(np.float32))
        card = ttr._product(Tc, x.cuda(), kind, getattr(Tc, table), getattr(Tc, table + "_x"))
        assert torch.backends.cuda.matmul.allow_tf32 is False
        plain = ttr._product(Th, x, kind, getattr(Th, table), getattr(Th, table + "_x"))
        mag = prec.contract(kind, getattr(Th, table + "_x").abs(),
                            prec.split(x, prec.DATA_AXIS[kind], mode).abs())
        k = prec.PARTS[mode] * K
        bound = 8.0 * (np.sqrt(k) * 2.0 ** -24 * mag.double()
                       + k * 2.0 ** -126 * float(x.abs().max()))
        assert ((card.cpu().double() - plain.double()).abs() <= bound).all(), name
        assert not torch.equal(card.cpu(), prec.contract(kind, getattr(Th, table), x)), name


def test_tf32_switch_restored_after_products_and_errors():
    from isca_tpu_torch.spectral import precision as prec

    matmul = torch.backends.cuda.matmul
    assert matmul.allow_tf32 is False
    with prec.tf32_products("cuda"):
        assert matmul.allow_tf32 is True
    assert matmul.allow_tf32 is False
    with pytest.raises(ZeroDivisionError):
        with prec.tf32_products("cuda"):
            1 / 0
    assert matmul.allow_tf32 is False
    # a caller who had it on finds it on
    matmul.allow_tf32 = True
    try:
        with prec.tf32_products("cuda"):
            pass
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = False


def test_highest_step_bit_equal_around_a_high_step():
    """A "highest" Held-Suarez step is the same to the bit before and after
    a "high" step ran in the same process: TF32 reaches no exact product."""
    from isca_tpu_torch.convert import primitive_state_to_numpy

    shape = dict(resolution="T42", num_levels=10, dt=1200.0)
    exact = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(dtype=torch.float32, **shape)))
    high = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(
        dtype=torch.float32, transform_precision="high", **shape)))
    s0 = exact.run(exact.initial_state(), 2)
    before = primitive_state_to_numpy(exact.step(s0))
    s_high = high.step(s0)
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    after = primitive_state_to_numpy(exact.step(s0))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    differ = primitive_state_to_numpy(s_high)
    assert any(not np.array_equal(differ[k], before[k]) for k in before)
