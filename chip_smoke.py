#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   the card's name and `nvidia-smi` name and power limit;
  build    compiles every kernel under isca_tpu_torch/csrc (nvcc, sm_90a) and
           reports the time and the compiler's register/spill lines;
  kernels  holds each kernel against its plain PyTorch version on the card,
           on seeded random inputs at the shapes of the main path and at an
           odd shape, times both with CUDA events, and reports the kernel's
           launch plan and resident blocks per SM;
  slice    drives the column path: the RRTM single-column model at T42 width
           (64 x 128 columns, 25 levels, float32, RRTMG-SW + grey LW) through
           ColumnModel.run; compares 3 steps with the same 3 steps on the CPU
           from an 8 x 16-column corner; times 20 more steps; counts the
           kernel launches of that run;
  profile  device time per step by kernel over 2 more steps of the slice
           (torch.profiler), launches per step and the device's idle share;
  dycore   drives the main path: the Held-Suarez spectral dycore through
           HeldSuarezModel.run at bench.py's configuration at full width
           (T85: 128 x 256 grid, 86 x 87 spectral triangle, 25 levels,
           dt = 600 s, float32) but with exact transforms
           (transform_precision="highest"); compares 3 steps from cold start
           with the same 3 steps on the CPU, within 3x the CPU's own
           float32-versus-float64 difference per field; warms up one model
           day, times 3 more one-day runs and prints ms per step, their
           median and held_suarez_T85L25_model_days_per_day;
  dycore_profile
           device time per step over 2 more dycore steps (torch.profiler):
           launches per step, idle share, the largest kernels, the device
           time and launches of the "dft", "legendre" and "implicit" stages
           (profiler ranges in the port; their matrix products are cuBLAS
           calls, not kernels of this repository), and the ATen ops that
           take most of the host's time.
  experiment
           drives both models through the run harness (Experiment) in a
           temporary directory: the HS model of `dycore` in two chained
           one-day segments with a daily file of ucomp, vcomp, temp and ps
           averaged and json_logging, held to the bit (torch.equal, every
           leaf) against one direct two-day run; checks each segment's
           NetCDF record and steps.jsonl line; prints each segment's ms per
           step against the `dycore` median and the direct run, the seconds
           of each flush and restart write, the restart's size, and the
           launches per step with and without the update of the averages.
           Then the column model at the slice's T42 width for one day with
           a daily temp and t_surf file: sw_flux must launch once per step,
           and the restart must load back to the end state bit for bit.
           Then the Frierson model of `moist` in two chained one-day
           segments with a daily temp, sphum and t_surf file, held to the
           bit against one direct two-day run.
  moist    drives the grey-moist Frierson aquaplanet GCM through
           GreyMoistModel.run at frierson_test_case_config(): T42 (64 x 128
           grid), 25 Frierson sigma levels, dt = 720 s, float32, "highest";
           nothing cut. Compares 3 steps from cold start with the same 3
           steps on the CPU, each field (sphum and t_surf among them) within
           3x the CPU's own float32-versus-float64 difference, and counts
           the columns whose convection switched on in one run and not the
           other; warms up, times three runs and prints ms per step, their
           median and frierson_T42L25_model_days_per_day; profiles 2 steps
           (launches per step, device ms, idle share, device time in the
           "physics" and "dynamics" ranges); then runs the same GCM with
           RRTM radiation (RRTMG-SW + grey LW) for a few steps, in which
           sw_flux must launch exactly once per step.
  simple   drives the stirred barotropic model
           (barotropic_vorticity_equation_test_case.py) and the shallow-water
           model (shallow_water_test_case.py) at T85 (128 x 256), dt = 1200 s,
           float32, nothing cut: 3 steps against the CPU within 3x the CPU's
           own float32-versus-float64 difference per field (s_stir among
           them; the float64 run is stirred by the float32 draws), the
           threefry key and the stirring draws equal to the CPU's
           bit for bit; a one-day warm-up, three timed one-day runs (72
           steps), ms per step, their median and <model>_T85_model_days_per_day;
           launches per step, device ms and idle share over 2 more steps, and
           the "stirring" and "threefry" ranges' launches.
  giant    giant_planet_model() (T42L30) 3 steps against the CPU as above;
           then the reference test case's T213L30 (dt = 1800 s, cutoff_wn =
           100, float32): 4 warm-up steps, three timed 10-step runs, median
           ms per step, giant_T213L30_model_days_per_day, launches per step,
           idle share, peak memory.
  moist_land
           the realistic-continents GCM (realistic_continents_test_case.py:
           GreyMoistConfig() T42L25 with the bucket, the idealized continents
           and the band-limited Sauliere 2012 topography through set_land),
           float32: 3 steps against the CPU (bucket_depth among the fields),
           timed runs, launches per step, idle share; the land's bucket must
           stay within [0, max_bucket_depth_land].
These three run after `moist_rrtm`; sw_flux must not launch on their paths
(its count on each is printed). `experiment` also runs the stirred
barotropic model in two chained one-day segments, held to the bit (the
stirring key too) against one direct two-day run.
Then the `{"kernels": [...]}` summary line, the raw `nvidia-smi` name and
power limit line, and last `{"ok": true, "device": {...}}`. Any failed phase
raises, so the script exits non-zero and prints no last line; so does a run
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM peaks used for the bound (NVIDIA data sheet): HBM3 bytes/s and
# FP32 (non-tensor-core) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

SEED = 20261017


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, warmup=3, reps=20):
    """Median time of fn() on the card over `reps` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gap_compare(gpu, cpu32, cpu64, factor, fields):
    """Each field's largest card-versus-CPU float32 difference against
    `factor` times the CPU's own float32-versus-float64 difference."""
    compare, ok = {}, True
    for k in fields:
        gap = float(np.abs(cpu32[k] - cpu64[k]).max())
        err = float(np.abs(gpu[k] - cpu32[k]).max())
        compare[k] = {"max_abs_diff": err, "tolerance": factor * gap, "cpu_f32_vs_f64": gap,
                      "card_vs_cpu_f64": float(np.abs(gpu[k] - cpu64[k]).max())}
        ok = ok and err <= factor * gap
    return compare, ok


def _timed_runs(model, state, warmup, steps, runs_n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.run(state, warmup, first=False)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(runs_n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.run(state, steps, first=False)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / steps)
    return state, warmup_s, runs


def _gcm_valid(name, model, state):
    d = state.dyn
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (d.ug.curr, d.vg.curr, d.tg.curr, d.psg.curr, d.tracers["sphum"].curr,
                  state.t_surf, state.bucket_depth.curr))
    valid = model.validity(state)
    if not finite or not bool(valid.ok):
        raise RuntimeError(f"{name}: state after the timed runs is not finite or out of "
                           f"range (finite={finite}, T in [{float(valid.vmin)}, "
                           f"{float(valid.vmax)}])")
    return [float(valid.vmin), float(valid.vmax)]


# ---------------------------------------------------------------------------
# sw_flux: the fused shortwave flux solve
# ---------------------------------------------------------------------------

# Operations per (column, layer, g-point) of the function itself, counted
# from rrtmg_sw.py (delta scaling, reftra_sw's non-conservative branch, the
# direct beam, both adding sweeps, the flux combine and the weighted g-sum),
# with each exp, sqrt and division counted as one operation. The cloudy
# variant does the layer properties twice and blends five of them.
SW_FLUX_OPS_PER_ELEMENT = {False: 150, True: 265}


def sw_flux_inputs(batch, L, cloudy, device, G=112, seed=SEED):
    """Random solve inputs in the style of tests/test_rrtmg_sw.py _inputs."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    tau = rng.gamma(1.5, 0.08, batch + (L, G))
    zinc = rng.uniform(0.0, 12.0, batch + (G,))
    zinc[..., ::7] = 0.0                      # some g-points carry no flux
    args = [f32(tau), f32(rng.uniform(0.0, 1.0, batch + (L, G))),
            f32(rng.uniform(0.0, 0.8, batch + (L, G))),
            f32(rng.uniform(0.05, 1.0, batch + (1, 1))),
            f32(rng.uniform(0.05, 0.6, batch + (G,))),
            f32(rng.uniform(0.05, 0.6, batch + (G,))), f32(zinc)]
    cloud = None
    if cloudy:
        cloud = (f32(tau + rng.gamma(2.0, 2.0, batch + (L, G))),
                 f32(rng.uniform(0.3, 1.0, batch + (L, G))),
                 f32(rng.uniform(0.0, 0.9, batch + (L, G))),
                 f32(rng.uniform(0.0, 1.0, batch + (L, G))))
    return args, cloud


def sw_flux_bound_ms(B, L, G, cloudy, itemsize=4):
    """Least time on the card: each input read once and each output written
    once over the memory rate, or the operations over the FP32 rate."""
    n_layer_arrays = 7 if cloudy else 3
    nbytes = itemsize * (n_layer_arrays * B * L * G + B + 3 * B * G + 3 * B * (L + 1))
    ops = SW_FLUX_OPS_PER_ELEMENT[cloudy] * B * L * G
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_sw_flux(name, batch, L, cloudy):
    """Kernel against sw_flux_solve_reference on the card, both timed."""
    from isca_tpu_torch.physics import rrtmg_sw

    args, cloud = sw_flux_inputs(batch, L, cloudy, "cuda")
    kernel = lambda: rrtmg_sw.sw_flux_solve(*args, cloud=cloud)
    plain = lambda: rrtmg_sw.sw_flux_solve_reference(*args, cloud=cloud)
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    # tests/test_rrtmg_sw.py's float32 tolerance for the fused solve:
    # reassociated float32 sums over G and L differ by ~1e-4 relative.
    scale = float(ref[0].abs().max())
    rtol, atol = 5e-4, 1e-4 * scale
    errs, ok = {}, True
    for a, b, field in zip(out, ref, ("swd", "swu", "dird")):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"sw_flux {name}: non-finite {field}")
        excess = ((a - b).abs() - (atol + rtol * b.abs())).max().item()
        errs[field] = float((a - b).abs().max())
        ok = ok and excess <= 0.0
    B = int(np.prod(batch))
    bound_ms, bound_by = sw_flux_bound_ms(B, L, 112, cloudy)
    plan = rrtmg_sw.sw_flux_plan(L, 112, 4)
    case = dict(case=name, shape=[B, L, 112], cloudy=cloudy, plan=plan._asdict(),
                blocks_per_sm=rrtmg_sw.sw_flux_blocks_per_sm(L, 112, torch.float32, cloudy),
                max_abs_err=max(errs.values()), errs=errs, rtol=rtol, atol=atol,
                ms=cuda_time_ms(kernel), plain_ms=cuda_time_ms(plain),
                bound_ms=bound_ms, bound_us=1e3 * bound_ms, bound_by=bound_by, ok=ok)
    emit({"phase": "kernels", "kernel": "sw_flux", **case})
    if not ok:
        raise RuntimeError(f"sw_flux {name}: kernel disagrees with its plain "
                           f"version beyond rtol={rtol}, atol={atol}: {errs}")
    return case


def phase_kernels():
    return [check_sw_flux("t42_clear", (8192,), 25, False),
            check_sw_flux("t42_cloudy", (8192,), 25, True),
            check_sw_flux("odd_clear", (7,), 5, False),
            check_sw_flux("odd_cloudy", (7,), 5, True)]


# ---------------------------------------------------------------------------
# slice: the RRTM single-column model at T42 width
# ---------------------------------------------------------------------------

T42_NLAT, T42_NLON, LEVELS, DT = 64, 128, 25, 600.0
CORNER = (8, 16)          # columns compared with the CPU run
COMPARE_STEPS, TIMED_STEPS = 3, 20

# float32 on the card against float32 on the CPU after 3 steps (absolute
# tolerances): the two differ by reassociated sums and last-bit differences
# of exp/log/pow that the physics carries forward. The top model level is
# ill-conditioned in float32: its Rayleigh-dominated layer has single-
# scattering albedo within 1e-6 of 1, where the two-stream cancels, and on
# the CPU float32 and float64 runs differ there by 0.012 K after 3 steps
# (4e-5 K on every other level).
T_ATOL_TOP, T_ATOL = 5e-2, 2e-3        # K
Q_RTOL, Q_ATOL = 1e-4, 1e-9            # kg/kg
TS_ATOL = 1e-3                         # K


def slice_config(nlat, nlon):
    from isca_tpu_torch.models.column import ColumnConfig
    from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig
    from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

    return ColumnConfig(
        nlat=nlat, nlon=nlon, num_levels=LEVELS, dt=DT, dtype=torch.float32,
        physics=MoistPhysicsConfig(
            radiation_scheme="rrtm",
            rrtm=RRTMConfig(lw_scheme="grey", do_seasonal=True, o3_mmr=1e-6)))


def slice_state(model, seed=SEED):
    """initial_state() with every column perturbed from a numpy seed (T +-5 K,
    q x 0.5..1.5, t_surf +-5 K): identical columns would hide a wrong column
    offset in a kernel. The clock starts at noon at the columns' longitude,
    so the shortwave solve has sunlit columns to work on."""
    from isca_tpu_torch.convert import column_state_to_numpy

    d = column_state_to_numpy(model.initial_state())
    rng = np.random.default_rng(seed)
    dT = rng.uniform(-5.0, 5.0, d["t_prev"].shape)
    sq = rng.uniform(0.5, 1.5, d["q_prev"].shape)
    for lvl in ("prev", "curr"):
        d[f"t_{lvl}"] = (d[f"t_{lvl}"] + dT).astype(np.float32)
        d[f"q_{lvl}"] = (d[f"q_{lvl}"] * sq).astype(np.float32)
    d["t_surf"] = (d["t_surf"] + rng.uniform(-5.0, 5.0, d["t_surf"].shape)).astype(np.float32)
    d["time_seconds"] = np.float32(0.5 * 86400.0)
    return d


def corner(d, nlat, nlon):
    return {k: (v[:nlat, :nlon] if np.ndim(v) >= 2 else v) for k, v in d.items()}


def compare_states(gpu, cpu):
    """Max errors of the compared fields and whether each is within tolerance."""
    err = lambda k: np.abs(gpu[k].astype(np.float64) - cpu[k])
    et, eq, es = err("t_curr"), err("q_curr"), err("t_surf")
    out = {"t_top": float(et[..., 0].max()), "t_below": float(et[..., 1:].max()),
           "q": float(eq.max()), "t_surf": float(es.max())}
    ok = (out["t_top"] <= T_ATOL_TOP and out["t_below"] <= T_ATOL
          and bool(np.all(eq <= Q_ATOL + Q_RTOL * np.abs(cpu["q_curr"])))
          and out["t_surf"] <= TS_ATOL)
    return out, ok


def phase_slice():
    """The main path on the card; returns the launches of each kernel, the
    model, its state and the measured ms per step."""
    from isca_tpu_torch.convert import column_state_from_numpy, column_state_to_numpy
    from isca_tpu_torch.models.column import ColumnModel
    from isca_tpu_torch.physics import rrtmg_sw

    model = ColumnModel(slice_config(T42_NLAT, T42_NLON))
    d0 = slice_state(model)
    cpu_model = ColumnModel(slice_config(*CORNER), device="cpu")
    cpu = column_state_to_numpy(cpu_model.run(
        column_state_from_numpy(corner(d0, *CORNER), device="cpu"), COMPARE_STEPS))

    state = column_state_from_numpy(d0)
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    state = model.run(state, COMPARE_STEPS)
    gpu = corner(column_state_to_numpy(state), *CORNER)
    errs, ok = compare_states(gpu, cpu)
    if not ok:
        raise RuntimeError(f"slice: card and CPU runs disagree after "
                           f"{COMPARE_STEPS} steps: {errs}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.run(state, TIMED_STEPS, first=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sw_flux": rrtmg_sw.sw_flux_solve.launches}

    final = column_state_to_numpy(state)
    for name in ("t_curr", "q_curr", "t_surf"):
        if not np.isfinite(final[name]).all():
            raise RuntimeError(f"slice: non-finite {name}")
    steps = COMPARE_STEPS + TIMED_STEPS
    if launches["sw_flux"] != steps:
        raise RuntimeError(f"slice: sw_flux launched {launches['sw_flux']} "
                           f"times in {steps} steps, expected one per step")
    ms_per_step = 1e3 * seconds / TIMED_STEPS
    emit({"phase": "slice", "columns": [T42_NLAT, T42_NLON], "levels": LEVELS,
          "dt": DT, "compare_steps": COMPARE_STEPS, "corner": list(CORNER),
          "compare": errs, "timed_steps": TIMED_STEPS, "ms_per_step": ms_per_step,
          "model_days_per_day": DT / (ms_per_step * 1e-3),
          "t_mean": float(final["t_curr"].mean()),
          "t_surf_mean": float(final["t_surf"].mean()), "launches": launches})
    return launches, model, state, ms_per_step


def phase_profile(model, state, ms_per_step, steps=2):
    """Device time of `steps` main-path steps by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.run(state, steps, first=False)
        torch.cuda.synchronize()
    # device-side rows only: the ATen op rows repeat their kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "profile", "steps": steps,
          "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / steps,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "top": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                   "launches_per_step": e.count / steps} for e in top]})


# ---------------------------------------------------------------------------
# dycore: the Held-Suarez spectral dycore at T85L25 (the main path)
# ---------------------------------------------------------------------------

HS_STEPS_PER_DAY, HS_TIMED_DAYS, HS_COMPARE_STEPS = 144, 3, 3
HS_FIELDS = ("ucomp", "vcomp", "temp", "ps", "vor", "div")
# card against CPU at float32 after 3 steps: the two sum in other orders
# (cuBLAS against the CPU's BLAS) and the float32 model amplifies rounding
# as it does between float32 and float64, so each field is held to this
# factor times the CPU's own float32-versus-float64 difference, measured in
# the same run from the same cold start
HS_TOL_FACTOR = 3.0
HS_STAGES = ("dft", "legendre", "implicit")
MOIST_STAGES = ("physics", "dynamics")
STIR_STAGES = ("stirring", "threefry")
ALL_STAGES = HS_STAGES + MOIST_STAGES + STIR_STAGES


def hs_config(dtype):
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.models.dry import HeldSuarezConfig
    from isca_tpu_torch.physics.hs_forcing import HSForcingConfig

    return HeldSuarezConfig(
        core=PrimitiveConfig(resolution="T85", num_levels=25, dt=600.0,
                             transform_precision="highest", dtype=dtype),
        forcing=HSForcingConfig())


def hs_fields(model, state):
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in model.diag_fields(state).items() if k in HS_FIELDS}


def phase_dycore():
    """The main path on the card; returns the model, its state and the
    median ms per step."""
    from isca_tpu_torch.models.dry import HeldSuarezModel

    cpu = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        m = HeldSuarezModel(hs_config(dtype), device="cpu")
        cpu[name] = hs_fields(m, m.run(m.initial_state(), HS_COMPARE_STEPS))

    model = HeldSuarezModel(hs_config(torch.float32))
    T = model.core.T
    state = model.run(model.initial_state(), HS_COMPARE_STEPS)
    gpu = hs_fields(model, state)
    compare, ok = gap_compare(gpu, cpu["float32"], cpu["float64"], HS_TOL_FACTOR, HS_FIELDS)
    if not ok:
        raise RuntimeError(f"dycore: card and CPU runs disagree after "
                           f"{HS_COMPARE_STEPS} steps: {compare}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.run(model.initial_state(), HS_STEPS_PER_DAY, first=True)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(HS_TIMED_DAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.run(state, HS_STEPS_PER_DAY, first=False)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / HS_STEPS_PER_DAY)
    ms_per_step = statistics.median(runs)
    finite = all(bool(torch.isfinite(x.curr).all())
                 for x in (state.ug, state.vg, state.tg, state.psg))
    valid = model.validity(state)
    if not finite or not bool(valid.ok):
        raise RuntimeError(f"dycore: state after {HS_TIMED_DAYS + 1} model days is "
                           f"not finite or out of range (finite={finite}, "
                           f"T in [{float(valid.vmin)}, {float(valid.vmax)}])")
    dt = model.config.core.dt
    core = model.config.core
    emit({"phase": "dycore", "model": "held_suarez", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "spectral": list(T.spec_shape),
          "levels": core.num_levels, "dt": dt, "dtype": str(core.dtype),
          "transform_precision": core.transform_precision,
          "width": "full: bench.py's T85L25 at exact transforms; depth not cut",
          "compare_steps": HS_COMPARE_STEPS, "tolerance_factor": HS_TOL_FACTOR,
          "compare": compare, "warmup_day_s": warmup_s, "timed_days": HS_TIMED_DAYS,
          "steps_per_day": HS_STEPS_PER_DAY, "ms_per_step_runs": runs,
          "ms_per_step_median": ms_per_step,
          "metric": "held_suarez_T85L25_model_days_per_day",
          "value": dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "finite": finite, "t_range": [float(valid.vmin), float(valid.vmax)],
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20})
    return model, state, ms_per_step


def _kernels_under(event):
    """Device kernels launched inside a profiler range or op, recursively."""
    out = list(event.kernels)
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def profile_stages(model, state, stage_names, steps=2):
    """torch.profiler over `steps` steps: (device kernel rows, device ms per
    step, per-stage rows of the named profiler ranges, the profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.run(state, steps, first=False)
        torch.cuda.synchronize()
    # device-side kernel rows only: the ATen op rows repeat their kernels'
    # time, and the stage ranges appear as device-side annotations too
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and e.key not in ALL_STAGES]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    stages = {}
    for e in prof.events():
        if e.name in stage_names and e.device_type == DeviceType.CPU:
            st = stages.setdefault(e.name, {"calls": 0, "kernels": {}})
            st["calls"] += 1
            for k in _kernels_under(e):
                row = st["kernels"].setdefault(k.name[:80], [0, 0.0])
                row[0] += 1
                row[1] += k.duration
    stage_rows = {}
    for name, st in stages.items():
        rows = sorted(st["kernels"].items(), key=lambda kv: -kv[1][1])
        stage_rows[name] = {
            "calls_per_step": st["calls"] / steps,
            "device_ms_per_step": sum(r[1] for _, r in rows) / 1e3 / steps,
            "launches_per_step": sum(r[0] for _, r in rows) / steps,
            "kernels": [{"kernel": kname, "ms_per_step": r[1] / 1e3 / steps,
                         "launches_per_step": r[0] / steps} for kname, r in rows[:6]]}
    missing = set(stage_names) - set(stage_rows)
    if missing or device_ms <= 0.0:
        raise RuntimeError(f"profile: no device time, or stages {sorted(missing)} "
                           "not in the trace")
    return kernels, device_ms, stage_rows, prof


def phase_dycore_profile(model, state, ms_per_step, steps=2):
    """Device time of `steps` dycore steps: by kernel and by stage."""
    from torch.autograd import DeviceType

    kernels, device_ms, stage_rows, prof = profile_stages(model, state, HS_STAGES, steps)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    # host side: ATen ops by their own CPU time (the profiler's overhead
    # inflates these; their shares say where the host's step goes)
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host_top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]
    emit({"phase": "dycore_profile", "steps": steps,
          "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / steps,
          "ms_per_step": ms_per_step,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": stage_rows,
          "top": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                   "launches_per_step": e.count / steps} for e in top],
          "host_ms_per_step_profiled": sum(e.self_cpu_time_total for e in host) / 1e3 / steps,
          "host_top": [{"op": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                        "calls_per_step": e.count / steps} for e in host_top]})


# ---------------------------------------------------------------------------
# moist: the grey-moist Frierson aquaplanet GCM at T42L25
# ---------------------------------------------------------------------------

FR_COMPARE_STEPS, FR_WARMUP_STEPS, FR_TIMED_STEPS, FR_TIMED_RUNS = 3, 6, 20, 3
FR_RRTM_STEPS = 3
FR_FIELDS = ("ps", "ucomp", "vcomp", "temp", "vor", "div", "omega", "sphum", "t_surf")
# as HS_TOL_FACTOR: the card against the CPU at float32, per field, within
# this factor times the CPU's own float32-versus-float64 difference
FR_TOL_FACTOR = 3.0


def frierson_config(dtype, **physics):
    """exp/test_cases/frierson/frierson_test_case.py at full width (T42,
    25 Frierson sigma levels, dt = 720 s) with exact transforms."""
    from isca_tpu_torch.models.moist import frierson_test_case_config

    cfg = frierson_test_case_config(dtype=dtype, transform_precision="highest")
    if physics:
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, **physics))
    return cfg


def moist_fields(model, state):
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in model.diag_fields(state).items() if k in FR_FIELDS}


def _moist_compare_run(model):
    """FR_COMPARE_STEPS steps from cold start, the last with the physics
    diagnostics: (fields, convecting columns, state)."""
    state = model.run(model.initial_state(), FR_COMPARE_STEPS - 1)
    state, diag = model.step_with_diagnostics(state)
    return moist_fields(model, state), diag["convection_rain"].cpu().numpy() > 0.0, state


def phase_moist():
    """The Frierson GCM on the card; returns the model, its state and the
    median ms per step."""
    from isca_tpu_torch.models.moist import GreyMoistModel

    cpu = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        cpu[name] = _moist_compare_run(GreyMoistModel(frierson_config(dtype), device="cpu"))
    model = GreyMoistModel(frierson_config(torch.float32))
    T = model.core.T
    gpu, gpu_conv, state = _moist_compare_run(model)
    compare, ok = gap_compare(gpu, cpu["float32"][0], cpu["float64"][0], FR_TOL_FACTOR,
                              FR_FIELDS)
    # a convection threshold that flips between two float32 runs shows as a
    # column convecting in one and not the other
    flips = {"card_vs_cpu_f32": int((gpu_conv != cpu["float32"][1]).sum()),
             "cpu_f32_vs_f64": int((cpu["float32"][1] != cpu["float64"][1]).sum()),
             "convecting_columns_cpu_f64": int(cpu["float64"][1].sum())}
    if not ok:
        raise RuntimeError(f"moist: card and CPU runs disagree after {FR_COMPARE_STEPS} "
                           f"steps: {compare}; convection flips {flips}")

    state, warmup_s, runs = _timed_runs(model, state, FR_WARMUP_STEPS, FR_TIMED_STEPS,
                                        FR_TIMED_RUNS)
    ms_per_step = statistics.median(runs)
    t_range = _gcm_valid("moist", model, state)
    core = model.config.core
    emit({"phase": "moist", "model": "frierson_test_case", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "spectral": list(T.spec_shape),
          "levels": core.num_levels, "dt": core.dt, "dtype": str(core.dtype),
          "transform_precision": core.transform_precision,
          "width": "full: frierson_test_case.py's T42L25; nothing cut",
          "compare_steps": FR_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
          "compare": compare, "convection_flips": flips,
          "warmup_steps": FR_WARMUP_STEPS, "warmup_s": warmup_s,
          "timed_runs": FR_TIMED_RUNS, "steps_per_run": FR_TIMED_STEPS,
          "ms_per_step_runs": runs, "ms_per_step_median": ms_per_step,
          "metric": "frierson_T42L25_model_days_per_day",
          "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "finite": True, "t_range": t_range,
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20})
    return model, state, ms_per_step


def phase_moist_profile(model, state, ms_per_step, steps=2):
    """Device time of `steps` Frierson steps: by kernel and in the "physics"
    and "dynamics" ranges."""
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MOIST_STAGES, steps)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "moist_profile", "steps": steps,
          "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / steps,
          "ms_per_step": ms_per_step,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": stage_rows,
          "top": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                   "launches_per_step": e.count / steps} for e in top]})


def phase_moist_rrtm():
    """The Frierson GCM with RRTM radiation (RRTMG-SW + grey LW): sw_flux
    once per step. Returns its launches."""
    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.physics import rrtmg_sw
    from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

    model = GreyMoistModel(frierson_config(
        torch.float32, radiation_scheme="rrtm", rrtm=RRTMConfig(lw_scheme="grey")))
    state = model.initial_state()
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    t0 = time.perf_counter()
    state, diag = model.step_with_diagnostics(model.run(state, FR_RRTM_STEPS - 1), False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rrtmg_sw.sw_flux_solve.launches
    if launches != FR_RRTM_STEPS:
        raise RuntimeError(f"moist_rrtm: sw_flux launched {launches} times in "
                           f"{FR_RRTM_STEPS} steps, expected one per step")
    d = state.dyn
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (d.tg.curr, d.tracers["sphum"].curr, state.t_surf, diag["swdn_sfc"]))
    if not finite:
        raise RuntimeError("moist_rrtm: the RRTM GCM's state is not finite")
    emit({"phase": "moist_rrtm", "steps": FR_RRTM_STEPS, "sw_flux_launches": launches,
          "columns": list(model.core.T.grid_shape), "levels": model.config.core.num_levels,
          "ms_per_step": 1e3 * seconds / FR_RRTM_STEPS, "finite": finite,
          "swdn_sfc_max": float(diag["swdn_sfc"].max())})
    return launches


# ---------------------------------------------------------------------------
# simple: the stirred barotropic and the shallow-water models at T85
# ---------------------------------------------------------------------------

SIMPLE_STEPS_PER_DAY, SIMPLE_TIMED_DAYS, SIMPLE_COMPARE_STEPS = 72, 3, 3
# as HS_TOL_FACTOR: per field, within this factor times the CPU's own
# float32-versus-float64 difference after the same steps
SIMPLE_TOL_FACTOR = 3.0
# the float64 reference's first s_stir against the float32 run's, relative to
# its largest coefficient: float32 rounding of the same draws
STIR_RTOL = 1e-5


def simple_config(kind, dtype):
    """exp/test_cases/barotropic_vorticity_equation_test_case.py and
    shallow_water_test_case.py at their T85 (128 x 256), dt = 1200 s."""
    if kind == "barotropic":
        from isca_tpu_torch.models.barotropic import BarotropicConfig
        return BarotropicConfig(resolution="T85", dt=1200.0, initial_zonal_wind="zero",
                                stirring_amplitude=3.0e-11, damping_order=2,
                                damping_coeff_r=1.929e-6, dtype=dtype)
    from isca_tpu_torch.models.shallow import ShallowConfig
    return ShallowConfig(resolution="T85", dt=1200.0, dtype=dtype)


def simple_model(kind, dtype, device=None):
    from isca_tpu_torch.models.barotropic import BarotropicModel
    from isca_tpu_torch.models.shallow import ShallowModel

    cls = BarotropicModel if kind == "barotropic" else ShallowModel
    return cls(simple_config(kind, dtype), device=device)


def _simple_fields(model, state):
    out = {k: v.detach().cpu().numpy().astype(np.float64)
           for k, v in model.diag_fields(state).items()}
    out["s_stir"] = state.s_stir.detach().cpu().numpy().astype(np.complex128)
    return out


def _draws_bit_equal(card_key, cpu_key):
    """The key, and the next step's stirring draws from it at float32 and
    float64, on the card against the CPU, bit for bit."""
    from isca_tpu_torch.utils import threefry

    if not torch.equal(card_key.cpu(), cpu_key):
        return False
    shape = (86, 87, 2)         # T85's spectral (m, n) shape, real and imaginary parts
    for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
        a = threefry.uniform(threefry.split(card_key)[1], shape, dtype, -1.0, 1.0).cpu()
        b = threefry.uniform(threefry.split(cpu_key)[1], shape, dtype, -1.0, 1.0)
        if not torch.equal(a.view(bits), b.view(bits)):
            return False
    return True


@contextlib.contextmanager
def float32_draws():
    """Stirring draws at float32 whatever the model's dtype, cast to it.

    At float64 threefry turns other bits into the mantissa than at float32,
    so a float64 run is stirred by other random numbers, and its difference
    from a float32 run would be the forcing's, not rounding. The float64
    reference run is given the float32 run's draws instead."""
    from isca_tpu_torch.physics import stirring
    from isca_tpu_torch.utils import threefry

    shim = types.SimpleNamespace(
        split=threefry.split,
        uniform=lambda key, shape, dtype, lo, hi: threefry.uniform(
            key, shape, torch.float32, lo, hi).to(dtype))
    stirring.threefry = shim
    try:
        yield
    finally:
        stirring.threefry = threefry


def _run_simple(kind):
    from isca_tpu_torch.physics import rrtmg_sw

    cpu, first_stir = {}, {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        m = simple_model(kind, dtype, device="cpu")
        s0 = m.initial_state()
        with float32_draws():
            s1 = m.step(s0, first=True)
            s = m.run(s1, SIMPLE_COMPARE_STEPS - 1, first=False)
        cpu[name] = (_simple_fields(m, s), s0.rng, s.rng)
        first_stir[name] = s1.s_stir.numpy().astype(np.complex128)
    # the float64 reference must be stirred by the float32 run's draws, or its
    # gap is the forcing's and not rounding: the first forcings agree to
    # float32 rounding (zero on both without stirring)
    scale = float(np.abs(first_stir["float32"]).max())
    stir_gap = float(np.abs(first_stir["float64"] - first_stir["float32"]).max())
    if (scale > 0.0) != (m.config.stirring_amplitude != 0.0) or stir_gap > STIR_RTOL * scale:
        raise RuntimeError(f"simple {kind}: the float64 reference run was not stirred by the "
                           f"float32 draws (first s_stir max {scale}, gap {stir_gap})")
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    model = simple_model(kind, torch.float32)
    T = model.T
    state0 = model.initial_state()
    state = model.run(state0, SIMPLE_COMPARE_STEPS)
    gpu = _simple_fields(model, state)
    compare, ok = gap_compare(gpu, cpu["float32"][0], cpu["float64"][0], SIMPLE_TOL_FACTOR,
                              list(gpu))
    # the first step's draws, and the key and next draws after the compared steps
    bits_equal = (_draws_bit_equal(state0.rng, cpu["float32"][1])
                  and _draws_bit_equal(state.rng, cpu["float32"][2])
                  and torch.equal(cpu["float32"][2], cpu["float64"][2]))
    if not ok or not bits_equal:
        raise RuntimeError(f"simple {kind}: card and CPU runs disagree after "
                           f"{SIMPLE_COMPARE_STEPS} steps: {compare}; key and draws "
                           f"bit-equal: {bits_equal}")

    state = model.run(model.initial_state(), 1, first=True)
    state, warmup_s, runs = _timed_runs(model, state, SIMPLE_STEPS_PER_DAY - 1,
                                        SIMPLE_STEPS_PER_DAY, SIMPLE_TIMED_DAYS)
    sw_launches = rrtmg_sw.sw_flux_solve.launches
    ms_per_step = statistics.median(runs)
    valid = model.validity(state)
    finite = bool(torch.isfinite(state.vorg.curr).all()) and bool(valid.ok)
    if not finite:
        raise RuntimeError(f"simple {kind}: state after {SIMPLE_TIMED_DAYS + 1} days is not "
                           f"finite or its winds out of range [{float(valid.vmin)}, "
                           f"{float(valid.vmax)}]")
    stages = ("dft", "legendre") + (STIR_STAGES if kind == "barotropic" else ())
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, stages)
    launches = sum(e.count for e in kernels) / 2
    stir_launches = stage_rows.get("stirring", {}).get("launches_per_step", 0.0)
    c = model.config
    return {"model": kind, "resolution": c.resolution, "grid": [T.nlat, T.nlon],
            "spectral": list(T.spec_shape), "dt": c.dt, "dtype": str(c.dtype),
            "stirring_amplitude": c.stirring_amplitude,
            "width": "full: the test case's T85; nothing cut",
            "compare_steps": SIMPLE_COMPARE_STEPS, "tolerance_factor": SIMPLE_TOL_FACTOR,
            "compare": compare, "key_and_draws_bit_equal": True,
            "reference_first_s_stir_gap": stir_gap, "reference_first_s_stir_max": scale,
            "warmup_steps": SIMPLE_STEPS_PER_DAY, "warmup_s": warmup_s,
            "steps_per_day": SIMPLE_STEPS_PER_DAY,
            "ms_per_step_runs": runs, "ms_per_step_median": ms_per_step,
            "metric": f"{kind}_T85_model_days_per_day",
            "value": c.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
            "launches_per_step": launches, "device_ms_per_step": device_ms,
            "idle_share": 1.0 - device_ms / ms_per_step, "stages": stage_rows,
            "stirring_launches_per_step": stir_launches,
            "stirring_launch_share": stir_launches / launches,
            "sw_flux_launches": sw_launches}


def phase_simple():
    """Both simple models on the card; returns the stirred barotropic model
    (for `experiment`) and each path's sw_flux launches."""
    out = {kind: _run_simple(kind) for kind in ("barotropic", "shallow")}
    emit({"phase": "simple", **out})
    return {f"simple_{k}": v["sw_flux_launches"] for k, v in out.items()}


# ---------------------------------------------------------------------------
# giant: the giant planet at the reference's T213L30
# ---------------------------------------------------------------------------

GIANT_COMPARE_STEPS, GIANT_WARMUP_STEPS, GIANT_TIMED_STEPS, GIANT_TIMED_RUNS = 3, 4, 10, 3
# a dry giant planet carries no water (initial_sphum = 0) and no slab
# (t_surf is never updated), so sphum and t_surf are left out
GIANT_FIELDS = ("ps", "ucomp", "vcomp", "temp", "vor", "div", "omega")
GIANT_BIG = dict(resolution="T213", num_levels=30, dt=1800.0, cutoff_wn=100)


def _gcm_compare_run(model, fields, steps):
    """`steps` steps from cold start: the named fields (bucket_depth among
    them when asked) as float64 numpy."""
    state = model.run(model.initial_state(), steps)
    out = {k: v.detach().cpu().numpy().astype(np.float64)
           for k, v in model.diag_fields(state).items() if k in fields}
    if "bucket_depth" in fields:
        out["bucket_depth"] = state.bucket_depth.curr.cpu().numpy().astype(np.float64)
    return out, state


def phase_giant():
    """The giant planet: accuracy at the CLI's T42L30, speed at T213L30.
    Returns its sw_flux launches."""
    from isca_tpu_torch.models.giant import giant_planet_model
    from isca_tpu_torch.physics import rrtmg_sw

    cpu = {name: _gcm_compare_run(giant_planet_model(dtype=dtype, device="cpu"),
                                  GIANT_FIELDS, GIANT_COMPARE_STEPS)[0]
           for name, dtype in (("float32", torch.float32), ("float64", torch.float64))}
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    gpu, _ = _gcm_compare_run(giant_planet_model(dtype=torch.float32), GIANT_FIELDS,
                              GIANT_COMPARE_STEPS)
    compare, ok = gap_compare(gpu, cpu["float32"], cpu["float64"], FR_TOL_FACTOR, GIANT_FIELDS)
    if not ok:
        raise RuntimeError(f"giant: card and CPU runs disagree after {GIANT_COMPARE_STEPS} "
                           f"steps at T42L30: {compare}")

    model = giant_planet_model(dtype=torch.float32, **GIANT_BIG)
    T = model.core.T
    state = model.run(model.initial_state(), 1, first=True)
    state, warmup_s, runs = _timed_runs(model, state, GIANT_WARMUP_STEPS - 1,
                                        GIANT_TIMED_STEPS, GIANT_TIMED_RUNS)
    sw_launches = rrtmg_sw.sw_flux_solve.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    t_range = _gcm_valid("giant", model, state)
    ms_per_step = statistics.median(runs)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MOIST_STAGES)
    core = model.config.core
    emit({"phase": "giant", "model": "giant_planet_model", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "spectral": list(T.spec_shape),
          "levels": core.num_levels, "dt": core.dt, "cutoff_wn": core.cutoff_wn,
          "dtype": str(core.dtype),
          "width": "full: the reference test case's T213L30; nothing cut",
          "compare_at": "giant_planet_model() defaults, T42L30 (a float64 CPU run at "
                        "T213L30 would take minutes)",
          "compare_steps": GIANT_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
          "compare": compare, "warmup_steps": GIANT_WARMUP_STEPS, "warmup_s": warmup_s,
          "timed_runs": GIANT_TIMED_RUNS, "steps_per_run": GIANT_TIMED_STEPS,
          "ms_per_step_runs": runs, "ms_per_step_median": ms_per_step,
          "metric": "giant_T213L30_model_days_per_day",
          "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "launches_per_step": sum(e.count for e in kernels) / 2,
          "device_ms_per_step": device_ms, "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": {k: {f: v[f] for f in ("device_ms_per_step", "launches_per_step")}
                     for k, v in stage_rows.items()},
          "t_range": t_range, "peak_memory_mb": peak_mb, "sw_flux_launches": sw_launches})
    return {"giant": sw_launches}


# ---------------------------------------------------------------------------
# moist_land: the realistic-continents GCM with bucket hydrology at T42L25
# ---------------------------------------------------------------------------

LAND_FIELDS = FR_FIELDS + ("bucket_depth",)


def continents_model(dtype, device=None):
    """exp/test_cases/realistic_continents_test_case.py: GreyMoistConfig()
    (T42L25, dt = 720 s) with the bucket, the idealized continents and the
    Sauliere 2012 topography band-limited through the model's truncation."""
    from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel
    from isca_tpu_torch.utils.land_generator import generate_land
    from isca_tpu_torch.utils.topography import band_limit_topography

    cfg = GreyMoistConfig()
    cfg = dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, dtype=dtype, transform_precision="highest"),
        physics=dataclasses.replace(cfg.physics, bucket=True))
    model = GreyMoistModel(cfg, device=device)
    T = model.core.T
    lats, lons = np.degrees(T.lats.cpu().numpy()), np.degrees(T.lons.cpu().numpy())
    land, topo = generate_land(lats, lons, "continents", topo_mode="sauliere2012")
    topo = band_limit_topography(T, np.asarray(topo, np.float64), n_smooth_passes=2,
                                 smooth_fraction=0.02)
    model.set_land(land, surf_geopotential=topo)
    return model


def phase_moist_land():
    """The realistic-continents GCM on the card. Returns its sw_flux launches."""
    from isca_tpu_torch.physics import rrtmg_sw

    cpu = {name: _gcm_compare_run(continents_model(dtype, device="cpu"), LAND_FIELDS,
                                  FR_COMPARE_STEPS)[0]
           for name, dtype in (("float32", torch.float32), ("float64", torch.float64))}
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    model = continents_model(torch.float32)
    T = model.core.T
    gpu, state = _gcm_compare_run(model, LAND_FIELDS, FR_COMPARE_STEPS)
    compare, ok = gap_compare(gpu, cpu["float32"], cpu["float64"], FR_TOL_FACTOR, LAND_FIELDS)
    if not ok:
        raise RuntimeError(f"moist_land: card and CPU runs disagree after {FR_COMPARE_STEPS} "
                           f"steps: {compare}")
    state, warmup_s, runs = _timed_runs(model, state, FR_WARMUP_STEPS, FR_TIMED_STEPS,
                                        FR_TIMED_RUNS)
    sw_launches = rrtmg_sw.sw_flux_solve.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    t_range = _gcm_valid("moist_land", model, state)
    land = model.land_mask > 0.5
    depth = state.bucket_depth.curr
    cap = model.config.physics.max_bucket_depth_land
    if not bool((depth[land] <= cap).all()) or not bool((depth >= 0).all()):
        raise RuntimeError("moist_land: a bucket depth left [0, cap] over land")
    ms_per_step = statistics.median(runs)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MOIST_STAGES)
    core = model.config.core
    emit({"phase": "moist_land", "model": "realistic_continents", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "levels": core.num_levels, "dt": core.dt,
          "dtype": str(core.dtype), "land_fraction": float(land.float().mean()),
          "zsurf_max_m": float(model.physics.zsurf.max()),
          "width": "full: realistic_continents_test_case.py's T42L25; nothing cut",
          "compare_steps": FR_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
          "compare": compare, "warmup_steps": FR_WARMUP_STEPS, "warmup_s": warmup_s,
          "timed_runs": FR_TIMED_RUNS, "steps_per_run": FR_TIMED_STEPS,
          "ms_per_step_runs": runs, "ms_per_step_median": ms_per_step,
          "metric": "realistic_continents_T42L25_model_days_per_day",
          "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "launches_per_step": sum(e.count for e in kernels) / 2,
          "device_ms_per_step": device_ms, "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": {k: {f: v[f] for f in ("device_ms_per_step", "launches_per_step")}
                     for k, v in stage_rows.items()},
          "bucket_depth_land_mean_m": float(depth[land].mean()),
          "t_range": t_range, "peak_memory_mb": peak_mb, "sw_flux_launches": sw_launches})
    return {"moist_land": sw_launches}


# ---------------------------------------------------------------------------
# experiment: the run harness (Experiment, diagnostics, restarts)
# ---------------------------------------------------------------------------

EXP_FIELDS = ("ucomp", "vcomp", "temp", "ps")     # the CLI's default fields
EXP_COLUMN = (64, 128)                             # the slice's T42 width


def _device_launches(fn, steps):
    """Device kernels launched per step by `steps` calls of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and e.key not in ALL_STAGES]
    return sum(e.count for e in kernels) / steps


class _Timings:
    """Seconds of each call of the wrapped functions, with the device
    drained first, so a call's time is its own and not the queued steps'."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, key, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return timed


def _states_equal(a, b):
    """Key paths whose leaves differ (dtype, shape or any bit)."""
    from isca_tpu_torch.utils.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return ["<structure>"]
    return [p for (p, x), (_, y) in zip(fa, fb)
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]


def _read_nc(path):
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        return {k: np.array(v[:]) for k, v in nc.variables.items()}


def phase_experiment(hs_model, dycore_ms, fr_model, fr_ms):
    """HS T85L25 through Experiment in two chained one-day segments, held to
    the bit against one direct two-day run; then the column slice through
    Experiment for one day, with sw_flux on its path; then the Frierson
    GCM in two chained one-day segments against one direct two-day run."""
    import tempfile

    import isca_tpu_torch.experiment as experiment
    from isca_tpu_torch.io.diag_manager import DiagManager

    timings = _Timings()
    patched = {(DiagManager, "flush"): DiagManager.flush,
               (experiment, "save_restart"): experiment.save_restart}
    DiagManager.flush = timings.wrap("flush", DiagManager.flush)
    experiment.save_restart = timings.wrap("restart", experiment.save_restart)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            hs = _experiment_hs(hs_model, dycore_ms, tmp, timings)
            col = _experiment_column(tmp, timings)
            fr = _experiment_frierson(fr_model, fr_ms, tmp, timings)
            baro = _experiment_barotropic(tmp, timings)
    finally:
        for (owner, name), fn in patched.items():
            setattr(owner, name, fn)
    emit({"phase": "experiment", "held_suarez": hs, "column": col, "frierson": fr,
          "barotropic": baro})
    return {"experiment_hs": hs["sw_flux_launches"], "experiment_column": col["sw_flux_launches"],
            "experiment_barotropic": baro["sw_flux_launches"]}


def _experiment_hs(model, dycore_ms, tmp, timings):
    import os

    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io.diag_manager import DiagManager, DiagTable
    from isca_tpu_torch.physics import rrtmg_sw
    from isca_tpu_torch.utils.tree import flatten_with_paths

    table = DiagTable().add_file("atmos_daily", 86400)
    for f in EXP_FIELDS:
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp = Experiment("held_suarez_T85L25", model, table, datadir=tmp, json_logging=True)
    walls = []
    rrtmg_sw.sw_flux_solve.launches = 0
    for i in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chained = exp.run(i, days=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = rrtmg_sw.sw_flux_solve.launches
    steps = HS_STEPS_PER_DAY
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = model.run(model.initial_state(), 2 * steps)
    torch.cuda.synchronize()
    direct_ms = 1e3 * (time.perf_counter() - t0) / (2 * steps)
    differ = _states_equal(chained, direct)
    if differ:
        again = _states_equal(direct, model.run(model.initial_state(), 2 * steps))
        raise RuntimeError(f"experiment: chained segments differ from the direct run in "
                           f"{differ}; two direct runs differ in {again or 'nothing'}")

    # each segment wrote one finite daily record and one steps.jsonl line
    grid = tuple(model.core.T.grid_shape)
    L = model.config.core.num_levels
    for i in (1, 2):
        rundir = os.path.join(exp.datadir, f"run{i:04d}")
        nc = _read_nc(os.path.join(rundir, "atmos_daily.nc"))
        for f in EXP_FIELDS:
            want = (1,) + ((L,) if f != "ps" else ()) + grid
            if nc[f].shape != want or not np.isfinite(nc[f]).all():
                raise RuntimeError(f"experiment: run {i} {f} has shape {nc[f].shape}, "
                                   f"want {want}, or is not finite")
        with open(os.path.join(rundir, "steps.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        if [r["day"] for r in rows] != [float(i)]:
            raise RuntimeError(f"experiment: run {i} steps.jsonl holds {rows}")
    if launches:
        raise RuntimeError(f"experiment: sw_flux launched {launches} times on the HS path")

    # launches per step: the bare step against the step with the update of
    # the daily averages (2 steps each)
    state = direct
    dm = DiagManager(table, np.zeros(grid[0]), np.zeros(grid[1]), outdir=tmp)
    ds = dm.init_state(model.diag_fields(state))
    box = {"s": state, "ds": ds}

    def bare():
        box["s"] = model.step(box["s"])

    def with_update():
        box["s"] = model.step(box["s"])
        box["ds"] = dm.update(box["ds"], model.diag_fields(box["s"]))

    bare_launches = _device_launches(bare, 2)
    update_launches = _device_launches(with_update, 2)
    res = os.path.join(exp.datadir, "restarts", "res0001.npz")
    flush_s, restart_s = timings.seconds["flush"][-2:], timings.seconds["restart"][-2:]
    seg_ms = [1e3 * w / steps for w in walls]
    return {
        "resolution": model.config.core.resolution, "levels": L, "grid": list(grid),
        "dtype": str(model.config.core.dtype), "segments": 2, "days_per_segment": 1,
        "steps_per_segment": steps, "chained_equals_direct": True,
        "segment_ms_per_step": seg_ms,
        "segment_ms_per_step_without_restart": [
            1e3 * (w - r) / steps for w, r in zip(walls, restart_s)],
        "dycore_ms_per_step": dycore_ms, "direct_ms_per_step": direct_ms,
        "ratio_to_dycore": [m / dycore_ms for m in seg_ms],
        "ratio_to_direct": [m / direct_ms for m in seg_ms],
        "flush_s": flush_s, "restart_write_s": restart_s,
        "restart_mb": os.path.getsize(res) / 1e6,
        "restart_leaf_mb": sum(v.numel() * v.element_size()
                               for _, v in flatten_with_paths(chained)) / 1e6,
        "launches_per_step_bare": bare_launches,
        "launches_per_step_with_update": update_launches,
        "sw_flux_launches": launches,
    }


def _experiment_column(tmp, timings):
    import os

    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io import restart
    from isca_tpu_torch.io.diag_manager import DiagTable
    from isca_tpu_torch.models.column import ColumnModel
    from isca_tpu_torch.physics import rrtmg_sw

    model = ColumnModel(slice_config(*EXP_COLUMN))
    table = DiagTable().add_file("atmos_daily", 86400)
    for f in ("temp", "t_surf"):
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp = Experiment("column_T42", model, table, datadir=tmp)
    steps = int(round(86400.0 / model.config.dt))
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    t0 = time.perf_counter()
    state = exp.run(1, days=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rrtmg_sw.sw_flux_solve.launches
    if launches != steps:
        raise RuntimeError(f"experiment: sw_flux launched {launches} times in the "
                           f"column's {steps} steps, expected one per step")
    res = os.path.join(exp.datadir, "restarts", "res0001.npz")
    differ = _states_equal(restart.load_restart(res, model.initial_state()), state)
    if differ:
        raise RuntimeError(f"experiment: the column restart does not load back to the "
                           f"segment's end state in {differ}")
    nc = _read_nc(os.path.join(exp.datadir, "run0001", "atmos_daily.nc"))
    want = (1, LEVELS) + EXP_COLUMN
    if nc["temp"].shape != want or not np.isfinite(nc["temp"]).all():
        raise RuntimeError(f"experiment: column temp has shape {nc['temp'].shape}, "
                           f"want {want}, or is not finite")
    return {"columns": list(EXP_COLUMN), "levels": LEVELS, "steps": steps,
            "ms_per_step": 1e3 * wall / steps, "sw_flux_launches": launches,
            "restart_round_trip": "bit for bit",
            "flush_s": timings.seconds["flush"][-1],
            "restart_write_s": timings.seconds["restart"][-1],
            "restart_mb": os.path.getsize(res) / 1e6}


FR_EXP_FIELDS = ("temp", "sphum", "t_surf")


def _experiment_frierson(model, moist_ms, tmp, timings):
    import os

    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io.diag_manager import DiagTable

    table = DiagTable().add_file("atmos_daily", 86400)
    for f in FR_EXP_FIELDS:
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp = Experiment("frierson_T42L25", model, table, datadir=tmp)
    steps = int(round(86400.0 / model.config.core.dt))
    walls = []
    for i in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chained = exp.run(i, days=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = model.run(model.initial_state(), 2 * steps)
    torch.cuda.synchronize()
    direct_ms = 1e3 * (time.perf_counter() - t0) / (2 * steps)
    differ = _states_equal(chained, direct)
    if differ:
        raise RuntimeError(f"experiment: the Frierson chained segments differ from the "
                           f"direct run in {differ}")
    grid = tuple(model.core.T.grid_shape)
    L = model.config.core.num_levels
    for i in (1, 2):
        nc = _read_nc(os.path.join(exp.datadir, f"run{i:04d}", "atmos_daily.nc"))
        for f in FR_EXP_FIELDS:
            want = (1,) + ((L,) if f != "t_surf" else ()) + grid
            if nc[f].shape != want or not np.isfinite(nc[f]).all():
                raise RuntimeError(f"experiment: Frierson run {i} {f} has shape "
                                   f"{nc[f].shape}, want {want}, or is not finite")
    seg_ms = [1e3 * w / steps for w in walls]
    restart_s = timings.seconds["restart"][-2:]
    return {"resolution": model.config.core.resolution, "levels": L, "grid": list(grid),
            "segments": 2, "days_per_segment": 1, "steps_per_segment": steps,
            "chained_equals_direct": True, "segment_ms_per_step": seg_ms,
            "segment_ms_per_step_without_restart": [
                1e3 * (w - r) / steps for w, r in zip(walls, restart_s)],
            "moist_ms_per_step": moist_ms, "direct_ms_per_step": direct_ms,
            "flush_s": timings.seconds["flush"][-2:], "restart_write_s": restart_s,
            "restart_mb": os.path.getsize(
                os.path.join(exp.datadir, "restarts", "res0001.npz")) / 1e6}


BARO_EXP_FIELDS = ("ucomp", "vcomp", "vor")     # the CLI's barotropic fields


def _experiment_barotropic(tmp, timings):
    """The stirred barotropic model of `simple` in two chained one-day
    segments, held to the bit (the stirring key too) against one direct
    two-day run: the key survives the restart."""
    import os

    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io.diag_manager import DiagTable
    from isca_tpu_torch.physics import rrtmg_sw

    model = simple_model("barotropic", torch.float32)
    table = DiagTable().add_file("atmos_daily", 86400)
    for f in BARO_EXP_FIELDS:
        table.add_field("atmos_daily", "dynamics", f, time_avg=True)
    exp = Experiment("barotropic_T85", model, table, datadir=tmp)
    steps = SIMPLE_STEPS_PER_DAY
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    walls = []
    for i in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chained = exp.run(i, days=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    direct = model.run(model.initial_state(), 2 * steps)
    torch.cuda.synchronize()
    launches = rrtmg_sw.sw_flux_solve.launches
    differ = _states_equal(chained, direct)
    key0 = model.initial_state().rng
    if differ or torch.equal(chained.rng, key0):
        raise RuntimeError(f"experiment: the barotropic chained segments differ from the "
                           f"direct run in {differ}, or the key never advanced")
    grid = tuple(model.T.grid_shape)
    for i in (1, 2):
        nc = _read_nc(os.path.join(exp.datadir, f"run{i:04d}", "atmos_daily.nc"))
        for f in BARO_EXP_FIELDS:
            if nc[f].shape != (1,) + grid or not np.isfinite(nc[f]).all():
                raise RuntimeError(f"experiment: barotropic run {i} {f} has shape "
                                   f"{nc[f].shape}, want {(1,) + grid}, or is not finite")
    restart_s = timings.seconds["restart"][-2:]
    return {"resolution": model.config.resolution, "grid": list(grid), "segments": 2,
            "days_per_segment": 1, "steps_per_segment": steps,
            "chained_equals_direct": True, "key": chained.rng.cpu().tolist(),
            "segment_ms_per_step": [1e3 * w / steps for w in walls],
            "segment_ms_per_step_without_restart": [
                1e3 * (w - r) / steps for w, r in zip(walls, restart_s)],
            "flush_s": timings.seconds["flush"][-2:], "restart_write_s": restart_s,
            "restart_mb": os.path.getsize(
                os.path.join(exp.datadir, "restarts", "res0001.npz")) / 1e6,
            "sw_flux_launches": launches}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from isca_tpu_torch import _build      # the package sets TF32 off on import

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "reports": reports})
    cases = phase_kernels()
    launches, model, state, ms_per_step = phase_slice()
    phase_profile(model, state, ms_per_step)
    hs_model, hs_state, hs_ms = phase_dycore()
    phase_dycore_profile(hs_model, hs_state, hs_ms)
    fr_model, fr_state, fr_ms = phase_moist()
    phase_moist_profile(fr_model, fr_state, fr_ms)
    rrtm_launches = phase_moist_rrtm()
    new_paths = {**phase_simple(), **phase_giant(), **phase_moist_land()}
    exp_launches = phase_experiment(hs_model, hs_ms, fr_model, fr_ms)
    main_case = cases[0]                      # the main path's shape and variant
    emit({"kernels": [{
        "name": "sw_flux", "route": "cuda",
        "source": "isca_tpu_torch/csrc/sw_flux.cu",
        "replaces": "isca_tpu/physics/rrtmg_sw.py:782",
        "launches": launches["sw_flux"],
        "launches_by_path": {"slice": launches["sw_flux"], "moist_rrtm": rrtm_launches,
                             **new_paths, **exp_launches},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "ok": all(c["ok"] for c in cases), "cases": cases}]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
