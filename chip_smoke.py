#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   the card's name and `nvidia-smi` name and power limit;
  build    compiles every kernel under isca_tpu_torch/csrc (nvcc, sm_90a) and
           reports the time and the compiler's register/spill lines;
  kernels  holds each kernel against its plain PyTorch version on the card,
           on seeded random inputs at the shapes of the main paths (sw_flux:
           8192 x 25 x 112 for RRTMG-SW and 8192 x 25 x 28 for SOCRATES,
           clear and cloudy) and at an odd shape, times both with CUDA
           events, and reports the kernel's launch plan and resident blocks
           per SM;
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
  mima     drives exp/test_cases/mima_test_case.py as written through
           GreyMoistModel.run: GreyMoistConfig() at T42L25, dt = 720 s, with
           RRTMG-SW and RRTMG-LW (RRTMConfig's "auto"), seasonal sun, ozone
           1e-6 and full Betts-Miller, float32, "highest"; nothing cut.
           3 steps against the CPU (olr and t_surf among the fields) by the
           3x rule; 6 warm-up steps and three timed 20-step runs, ms per
           step, their median and mima_T42L25_model_days_per_day; sw_flux
           exactly once per step; peak memory; 2 profiled steps (launches,
           device ms in the "physics", "dynamics" and "rrtmg_lw" ranges,
           idle share).
  mima_dt_rad
           the same model with MiMA's dt_rad = 7200 s (n_rad = 10): sw_flux
           at steps 1 and 11 of 20 from cold start and twice in each of
           three timed 20-step runs; ms per step, its median and
           mima_dt_rad7200_T42L25_model_days_per_day; 10 profiled steps.
  socrates, socrates_cloud, simple_clouds
           drive exp/test_cases/socrates_aquaplanet_test_case.py (without
           and with --clouds: SOCRATES radiation, float32 in its own
           right, SimCloud feeding its cloud optics) and
           simple_clouds_test_case.py (RRTMG-SW and RRTMG-LW with SimCloud:
           sw_flux clear then cloudy, RRTMG-LW's cloudy sweeps) as written
           at T42L25, float32, "highest": 3 steps against the CPU by the 3x
           rule (olr, and cf with clouds, among the fields) from a moist
           start (0.01 kg/kg, so that the clouds are there); then the test
           case as written: 3 warm-up steps, three timed 10-step runs, ms
           per step, their median and <test case>_T42L25_model_days_per_day,
           sw_flux once per step (twice on simple_clouds), peak memory, 2
           profiled steps (launches, idle share, device ms in the
           "physics", "dynamics", "socrates", "rrtmg_lw" and "cloud_simple"
           ranges).
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
  mima_gwd MiMA as mima_test_case.py writes it (T42L25) plus mima.nml's
           damping (Rayleigh sponge below 50 Pa) and the Alexander-Dunkerton
           convective gravity-wave drag (do_cg_drag), with seeded 12-month
           ozone (on pressure levels, RRTM's o3 input) and q-flux series
           (isca_tpu_torch/models/cases.py: the real input files are not
           in the repository): 3 steps against the CPU by the 3x rule
           (gwfu_cgwd and olr among the fields); 3 warm-up steps, three
           timed 10-step runs, mima_gwd_T42L25_model_days_per_day, sw_flux
           once per step, peak memory, 2 profiled steps with the "cg_drag"
           and "rrtmg_lw" ranges.
  continents_sst
           the realistic continents (T42L25, the bucket) with prescribed
           ocean SSTs (do_sc_sst, specify_sst_over_ocean_only), a sea-ice
           albedo and the orographic gravity-wave drag (do_mg_drag, hprime
           300 m over land), the SST and ice series seeded: 3 steps against
           the CPU (albedo and udt_gwd among the fields), the ocean's
           surface temperature equal to the SST series and the land's not,
           timed runs as mima_gwd, the "mg_drag" range; sw_flux 0.
  ras_bl   frierson_test_case_config() with RAS: 3 steps against the CPU from
           a conditionally unstable start (cases.convective_start; the cold
           start convects nowhere), timed runs from the cold start as
           mima_gwd, the "ras" range; then with simple Betts-Miller and each
           of bl_scheme = mellor_yamada (tke among the fields), edt, entrain
           and stable_bl with do_shallow_conv: 3 steps against the CPU at
           T21L25 (BL_COMPARE_RESOLUTION) and one timed 10-step run at
           T42L25 each, 2 profiled steps with the scheme's
           range. The cloud-base level klcl and the PBL top z_pbl are
           discrete choices, held by counting the columns whose choice
           differs (CHOICE_FIELDS). sw_flux 0.
  sharded  the sharded run (isca_tpu_torch.parallel.mesh): 2 ranks spawned
           on the one card over gloo, which stages its collectives through
           the host. HS T85L25 and Frierson T42L25 (the `dycore` and `moist`
           configurations with PrimitiveConfig(mesh=...)), float32, 3 steps
           sharded from cold start, the gathered fields held by the 3x rule
           against the CPU runs of `dycore` and `moist` and compared with
           those phases' 3 card steps on one device; each rank's m rows and
           its spectral block distinct; an HS tile restart written by both
           ranks, read back into each rank's blocks and combined into one
           file, both bit-equal; 10 timed steps (ms per step), then 10 with
           every all_to_all and all_reduce synchronised and timed (their
           share of that step). A correctness run on one card, not a
           scaling number. sw_flux must not launch. With two or more
           cards the same again over NCCL, one card per rank; with one, a
           line says so.
The CPU's float32 and float64 runs that mima_gwd, continents_sst and
ras_bl compare with are made by two worker processes (two threads each,
`cpu_reference`), started after the build, so that they run beside the
earlier phases; the earlier phases' card timings share the host with them.
The two mima phases run after `moist_rrtm`, then the three cloud and
SOCRATES phases, then simple, giant, moist_land, mima_gwd, continents_sst
and ras_bl; sw_flux must not launch on the paths of simple, giant,
moist_land, continents_sst and ras_bl (its count on each is printed). `experiment` also runs the stirred
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
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

# H100 SXM peaks used for the bound (NVIDIA data sheet): HBM3 bytes/s and
# FP32 (non-tensor-core) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

SEED = 20261017
# the card's 3-step fields and the CPU's float32 and float64 fields of the
# `dycore` and `moist` comparisons, which `sharded` compares with again
COMPARE_REFS = {}


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
SOCRATES_G = 28        # g-points of SOCRATES' synthetic SW spectrum


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


def check_sw_flux(name, batch, L, cloudy, G=112):
    """Kernel against sw_flux_solve_reference on the card, both timed, at
    batch x L x G (G = 112 for RRTMG-SW, 28 for SOCRATES' SW spectrum)."""
    from isca_tpu_torch.physics import rrtmg_sw

    args, cloud = sw_flux_inputs(batch, L, cloudy, "cuda", G=G)
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
    bound_ms, bound_by = sw_flux_bound_ms(B, L, G, cloudy)
    plan = rrtmg_sw.sw_flux_plan(L, G, 4)
    case = dict(case=name, shape=[B, L, G], cloudy=cloudy, plan=plan._asdict(),
                blocks_per_sm=rrtmg_sw.sw_flux_blocks_per_sm(L, G, torch.float32, cloudy),
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
            check_sw_flux("socrates_clear", (8192,), 25, False, G=SOCRATES_G),
            check_sw_flux("socrates_cloudy", (8192,), 25, True, G=SOCRATES_G),
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
MIMA_STAGES = MOIST_STAGES + ("rrtmg_lw",)
CLOUD_STAGES = ("socrates", "cloud_simple")
# the drags' and the convection and boundary-layer schemes' ranges
SCHEME_STAGES = ("cg_drag", "mg_drag", "ras", "my25", "edt", "entrain", "stable_bl",
                 "shallow_conv")
ALL_STAGES = HS_STAGES + MIMA_STAGES + STIR_STAGES + CLOUD_STAGES + SCHEME_STAGES


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
    COMPARE_REFS["held_suarez"] = (gpu, cpu["float32"], cpu["float64"])
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
    COMPARE_REFS["frierson"] = (gpu, cpu["float32"][0], cpu["float64"][0])
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
# mima: exp/test_cases/mima_test_case.py at T42L25, and with MiMA's dt_rad
# ---------------------------------------------------------------------------

MIMA_FIELDS = FR_FIELDS + ("olr",)
MIMA_DT_RAD = 7200.0          # exp/namelists/mima.nml:87
MIMA_DT_RAD_STEPS, MIMA_DT_RAD_PROFILE_STEPS = 20, 10


def mima_config(dtype, dt_rad=0.0):
    """mima_test_case.py as written (GreyMoistConfig(): T42, 25 uneven-sigma
    levels, dt = 720 s; RRTMG-SW + RRTMG-LW, seasonal sun, o3 1e-6; full
    Betts-Miller) with exact transforms; dt_rad > dt substeps radiation."""
    from isca_tpu_torch.models.moist import mima_test_case_config

    cfg = mima_test_case_config(dtype=dtype, transform_precision="highest")
    if dt_rad:
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, dt_rad=dt_rad))
    return cfg


def _mima_compare_run(model):
    """FR_COMPARE_STEPS steps from cold start: (fields with the last step's
    OLR, convecting columns, state)."""
    state = model.run(model.initial_state(), FR_COMPARE_STEPS - 1)
    state, diag = model.step_with_diagnostics(state)
    fields = moist_fields(model, state)
    fields["olr"] = diag["olr"].cpu().numpy().astype(np.float64)
    return fields, diag["convection_rain"].cpu().numpy() > 0.0, state


def phase_mima():
    """The MiMA test case on the card: 3 steps against the CPU, timed runs
    with sw_flux once per step, a profile. Returns the path's launches."""
    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.physics import rrtmg_sw

    t_phase = time.perf_counter()
    cpu = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        cpu[name] = _mima_compare_run(GreyMoistModel(mima_config(dtype), device="cpu"))
    model = GreyMoistModel(mima_config(torch.float32))
    if model.physics.radiation.lw_rrtmg is None:
        raise RuntimeError("mima: RRTMConfig() did not select RRTMG-LW")
    T = model.core.T
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    gpu, gpu_conv, state = _mima_compare_run(model)
    compare, ok = gap_compare(gpu, cpu["float32"][0], cpu["float64"][0], FR_TOL_FACTOR,
                              MIMA_FIELDS)
    flips = {"card_vs_cpu_f32": int((gpu_conv != cpu["float32"][1]).sum()),
             "cpu_f32_vs_f64": int((cpu["float32"][1] != cpu["float64"][1]).sum()),
             "convecting_columns_cpu_f64": int(cpu["float64"][1].sum())}
    if not ok:
        raise RuntimeError(f"mima: card and CPU runs disagree after {FR_COMPARE_STEPS} "
                           f"steps: {compare}; convection flips {flips}")
    state, warmup_s, runs = _timed_runs(model, state, FR_WARMUP_STEPS, FR_TIMED_STEPS,
                                        FR_TIMED_RUNS)
    torch.cuda.synchronize()
    launches = rrtmg_sw.sw_flux_solve.launches
    steps = FR_COMPARE_STEPS + FR_WARMUP_STEPS + FR_TIMED_RUNS * FR_TIMED_STEPS
    if launches != steps:
        raise RuntimeError(f"mima: sw_flux launched {launches} times in {steps} steps, "
                           "expected one per step")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_per_step = statistics.median(runs)
    t_range = _gcm_valid("mima", model, state)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MIMA_STAGES)
    core = model.config.core
    emit({"phase": "mima", "model": "mima_test_case", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "spectral": list(T.spec_shape),
          "levels": core.num_levels, "dt": core.dt, "dtype": str(core.dtype),
          "transform_precision": core.transform_precision,
          "width": "full: mima_test_case.py's T42L25 as written; nothing cut",
          "compare_steps": FR_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
          "compare": compare, "convection_flips": flips,
          "warmup_steps": FR_WARMUP_STEPS, "warmup_s": warmup_s,
          "timed_runs": FR_TIMED_RUNS, "steps_per_run": FR_TIMED_STEPS,
          "ms_per_step_runs": runs, "ms_per_step_median": ms_per_step,
          "metric": "mima_T42L25_model_days_per_day",
          "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "sw_flux_launches": launches, "steps": steps, "t_range": t_range,
          "peak_memory_mb": peak_mb, "profile_steps": 2,
          "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / 2,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": stage_rows, "phase_seconds": time.perf_counter() - t_phase})
    return launches


def phase_mima_dt_rad():
    """The MiMA test case with dt_rad = 7200 s (n_rad = 10): sw_flux at steps
    1 and 11 of 20 from cold start, then timed runs. Returns the path's
    launches."""
    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.physics import rrtmg_sw

    t_phase = time.perf_counter()
    model = GreyMoistModel(mima_config(torch.float32, MIMA_DT_RAD))
    dt = model.config.core.dt
    state = model.initial_state()
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    at = []
    t0 = time.perf_counter()
    for i in range(MIMA_DT_RAD_STEPS):
        before = rrtmg_sw.sw_flux_solve.launches
        state = model.step(state, first=i == 0)
        at.extend([i + 1] * (rrtmg_sw.sw_flux_solve.launches - before))
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0) / MIMA_DT_RAD_STEPS
    if at != [1, 11]:
        raise RuntimeError(f"mima_dt_rad: sw_flux launched at steps {at} of "
                           f"{MIMA_DT_RAD_STEPS}, expected [1, 11]")
    state, _, runs = _timed_runs(model, state, 0, MIMA_DT_RAD_STEPS, FR_TIMED_RUNS)
    torch.cuda.synchronize()
    launches = rrtmg_sw.sw_flux_solve.launches
    want = 2 * (1 + FR_TIMED_RUNS)
    if launches != want:
        raise RuntimeError(f"mima_dt_rad: sw_flux launched {launches} times in "
                           f"{(1 + FR_TIMED_RUNS) * MIMA_DT_RAD_STEPS} steps, expected {want}")
    ms_per_step = statistics.median(runs)
    t_range = _gcm_valid("mima_dt_rad", model, state)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MIMA_STAGES,
                                                       MIMA_DT_RAD_PROFILE_STEPS)
    emit({"phase": "mima_dt_rad", "dt_rad": MIMA_DT_RAD,
          "n_rad": int(round(MIMA_DT_RAD / dt)), "sw_flux_at_steps": at,
          "cold_start_ms_per_step": cold_ms, "timed_runs": FR_TIMED_RUNS,
          "steps_per_run": MIMA_DT_RAD_STEPS, "ms_per_step_runs": runs,
          "ms_per_step_median": ms_per_step,
          "metric": "mima_dt_rad7200_T42L25_model_days_per_day",
          "value": dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "sw_flux_launches": launches, "t_range": t_range,
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
          "profile_steps": MIMA_DT_RAD_PROFILE_STEPS, "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / MIMA_DT_RAD_PROFILE_STEPS,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": {k: {f: v[f] for f in ("device_ms_per_step", "launches_per_step")}
                     for k, v in stage_rows.items()},
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# socrates, socrates_cloud, simple_clouds: the SOCRATES aquaplanet without and
# with SimCloud, and RRTM with SimCloud, at T42L25
# ---------------------------------------------------------------------------

CLOUD_WARMUP_STEPS, CLOUD_TIMED_STEPS = 3, 10
# The test cases start dry (2e-6 kg/kg) and make no cloud in a few steps, so
# the card-against-CPU steps start moist: a uniform 0.01 kg/kg, which the
# condensation brings to saturation in the upper levels, where SimCloud then
# puts cloud fraction 1. The timed runs start as the test cases are written.
MOIST_START_SPHUM = 0.01
# name: (test case, metric stem, its profiler ranges besides MOIST_STAGES,
# sw_flux launches per step)
CLOUD_PHASES = {
    "socrates": ("socrates_aquaplanet_test_case.py", "socrates_aquaplanet",
                 ("socrates",), 1),
    "socrates_cloud": ("socrates_aquaplanet_test_case.py --clouds",
                       "socrates_aquaplanet_with_cloud", ("socrates", "cloud_simple"), 1),
    "simple_clouds": ("simple_clouds_test_case.py", "simple_clouds",
                      ("rrtmg_lw", "cloud_simple"), 2),
}


def cloud_phase_config(name, dtype, moist_start=False):
    """The phase's exp test case as written (T42L25, dt = 720 s) with exact
    transforms; moist_start sets the initial humidity to MOIST_START_SPHUM."""
    from isca_tpu_torch.models import moist

    build = {"socrates": lambda **kw: moist.socrates_aquaplanet_test_case_config(False, **kw),
             "socrates_cloud": lambda **kw: moist.socrates_aquaplanet_test_case_config(True, **kw),
             "simple_clouds": moist.simple_clouds_test_case_config}[name]
    cfg = build(dtype=dtype, transform_precision="highest")
    return dataclasses.replace(cfg, initial_sphum=MOIST_START_SPHUM) if moist_start else cfg


def _cloud_compare_run(model):
    """FR_COMPARE_STEPS steps from a cold start: the FR_FIELDS, the last
    step's OLR and, with clouds, its cloud fraction."""
    state = model.run(model.initial_state(), FR_COMPARE_STEPS - 1)
    state, diag = model.step_with_diagnostics(state)
    fields = moist_fields(model, state)
    for k in ("olr", "cf"):
        if k in diag:
            fields[k] = diag[k].cpu().numpy().astype(np.float64)
    return fields


def phase_cloud_gcm(name):
    """One of CLOUD_PHASES on the card: 3 moist-start steps against the CPU
    by the 3x rule, then the test case as written: CLOUD_WARMUP_STEPS steps,
    three timed CLOUD_TIMED_STEPS-step runs, sw_flux launches per step
    checked, a profile. Returns the launches of the path."""
    import warnings

    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.physics import rrtmg_sw

    test_case, stem, stages, per_step = CLOUD_PHASES[name]
    t_phase = time.perf_counter()
    with warnings.catch_warnings():
        # the committed RRTMG-LW k-tables are synthetic and say so
        warnings.simplefilter("ignore", RuntimeWarning)
        cpu32, cpu64 = (_cloud_compare_run(GreyMoistModel(
            cloud_phase_config(name, dtype, moist_start=True), device="cpu"))
            for dtype in (torch.float32, torch.float64))
        torch.cuda.synchronize()
        rrtmg_sw.sw_flux_solve.launches = 0
        gpu = _cloud_compare_run(GreyMoistModel(
            cloud_phase_config(name, torch.float32, moist_start=True)))
        model = GreyMoistModel(cloud_phase_config(name, torch.float32))
    torch.cuda.synchronize()
    compare, ok = gap_compare(gpu, cpu32, cpu64, FR_TOL_FACTOR, tuple(gpu))
    launches = rrtmg_sw.sw_flux_solve.launches
    if not ok or launches != per_step * FR_COMPARE_STEPS:
        raise RuntimeError(f"{name}: card and CPU runs disagree after {FR_COMPARE_STEPS} "
                           f"moist-start steps, or sw_flux launched {launches} times, "
                           f"expected {per_step} per step: {compare}")
    cloud = ({"cf_max": float(gpu["cf"].max()), "cloudy_share": float((gpu["cf"] > 0).mean())}
             if "cf" in gpu else None)

    state = model.run(model.initial_state(), CLOUD_WARMUP_STEPS)
    state, _, runs = _timed_runs(model, state, 0, CLOUD_TIMED_STEPS, FR_TIMED_RUNS)
    torch.cuda.synchronize()
    steps = CLOUD_WARMUP_STEPS + FR_TIMED_RUNS * CLOUD_TIMED_STEPS
    timed_launches = rrtmg_sw.sw_flux_solve.launches - launches
    if timed_launches != per_step * steps:
        raise RuntimeError(f"{name}: sw_flux launched {timed_launches} times in {steps} "
                           f"steps, expected {per_step} per step")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_per_step = statistics.median(runs)
    t_range = _gcm_valid(name, model, state)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MOIST_STAGES + stages)
    core, T = model.config.core, model.core.T
    emit({"phase": name, "model": test_case, "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "levels": core.num_levels, "dt": core.dt,
          "dtype": str(core.dtype), "transform_precision": core.transform_precision,
          "width": f"full: {test_case} at T42L25 as written; nothing cut",
          "compare_steps": FR_COMPARE_STEPS, "compare_initial_sphum": MOIST_START_SPHUM,
          "tolerance_factor": FR_TOL_FACTOR, "compare": compare, "compare_clouds": cloud,
          "warmup_steps": CLOUD_WARMUP_STEPS, "timed_runs": FR_TIMED_RUNS,
          "steps_per_run": CLOUD_TIMED_STEPS, "ms_per_step_runs": runs,
          "ms_per_step_median": ms_per_step, "metric": f"{stem}_T42L25_model_days_per_day",
          "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
          "sw_flux_launches": launches + timed_launches,
          "sw_flux_per_step": per_step, "t_range": t_range, "peak_memory_mb": peak_mb,
          "profile_steps": 2, "device_ms_per_step": device_ms,
          "launches_per_step": sum(e.count for e in kernels) / 2,
          "idle_share": 1.0 - device_ms / ms_per_step,
          "stages": stage_rows, "phase_seconds": time.perf_counter() - t_phase})
    return launches + timed_launches


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


def continents_model(dtype, device=None, continents_sst=False):
    """exp/test_cases/realistic_continents_test_case.py: GreyMoistConfig()
    (T42L25, dt = 720 s) with the bucket, the idealized continents and the
    Sauliere 2012 topography band-limited through the model's truncation;
    continents_sst adds cases.py's prescribed ocean SSTs, sea ice and
    orographic drag (hprime 300 m over land)."""
    from isca_tpu_torch.models import cases
    from isca_tpu_torch.models.moist import GreyMoistModel

    return cases.set_continents(GreyMoistModel(cases.continents_config(
        dtype, continents_sst, transform_precision="highest"), device=device))


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
# mima_gwd, continents_sst, ras_bl: the gravity-wave drags, the series and the
# other convection and boundary-layer schemes at T42L25
# ---------------------------------------------------------------------------

NEW_WARMUP_STEPS, NEW_TIMED_STEPS = 3, 10
MIMA_GWD_FIELDS = MIMA_FIELDS + ("gwfu_cgwd",)
SST_FIELDS = LAND_FIELDS + ("albedo", "udt_gwd")
# Discrete choices (the cloud-base level klcl; the PBL top z_pbl where a
# scheme picks it from a level) jump where float32 rounding moves a value
# across a threshold, so they are not held to the 3x rule: the columns where
# the card's choice differs from the CPU's float32 one (by more than 1e-3 of
# the value, or 1e-3 where it is below 1) are counted, beside the columns
# where the CPU's float32 and float64 runs differ, and the card may differ
# in at most 3x as many columns as the CPU's own count plus one per
# thousand columns.
CHOICE_FIELDS = ("klcl", "z_pbl")
# the start of each ras_bl comparison: the convective one where the scheme
# acts only in a moist, conditionally unstable column (RAS; the stable-BL
# variant's shallow convection), the cold start where the surface, warmer
# than the isothermal air, drives the boundary layer (MY2.5, EDT, entrain)
RAS_BL_STARTS = {"RAS": "convective", "mellor_yamada": "cold", "edt": "cold",
                 "entrain": "cold", "stable_bl": "convective"}
# The new paths' CPU runs (float32 and float64, 3 steps each) are made by
# CPU_REF_WORKERS worker processes of CPU_REF_THREADS threads, started with
# the script, so that they run beside the card's earlier phases; the longest
# (mima_gwd's RRTMG-LW at float64) is submitted first.
NEW_PATHS = ("mima_gwd", "RAS", "continents_sst", "mellor_yamada", "edt", "entrain",
             "stable_bl")
CPU_REF_WORKERS, CPU_REF_THREADS = 2, 2
# The four boundary-layer variants compare 3 steps with the CPU at T21L25
# (their timed runs are at T42L25): the CPU's float32 and float64 runs at
# T42 would take the whole script past 900 s.
BL_COMPARE_RESOLUTION = "T21"
RAS_BL_STAGES = {"RAS": ("ras",), "mellor_yamada": ("my25",), "edt": ("edt",),
                 "entrain": ("entrain",), "stable_bl": ("stable_bl", "shallow_conv")}


def _diag_compare_run(model, state, fields, steps=FR_COMPARE_STEPS):
    """`steps` steps from `state`, the last with the physics diagnostics:
    the named fields (diag_fields, then the diagnostics, then the state's
    bucket depth and TKE) as float64 numpy, the columns that convect, and
    the state."""
    state = model.run(state, steps - 1)
    state, diag = model.step_with_diagnostics(state, first=steps == 1)
    diag = dict(diag, bucket_depth=state.bucket_depth.curr, tke=state.tke)
    out = {k: diag[k].detach().cpu().numpy().astype(np.float64) for k in fields}
    conv = (diag["convection_rain"].cpu().numpy() > 0.0 if "convection_rain" in diag
            else None)
    return out, conv, state


def _choices(gpu, cpu32, cpu64, names):
    """CHOICE_FIELDS' differing columns, card against CPU float32 and CPU
    float32 against float64; ok when within the rule."""
    out, ok = {}, True
    for k in names:
        differ = lambda a, b: int((np.abs(a - b) > 1e-3 * np.maximum(np.abs(b), 1.0)).sum())
        card, cpu = differ(gpu[k], cpu32[k]), differ(cpu32[k], cpu64[k])
        allowed = 3 * cpu + max(1, gpu[k].size // 1000)
        out[k] = {"card_vs_cpu_f32": card, "cpu_f32_vs_f64": cpu, "allowed": allowed,
                  "columns": int(gpu[k].size), "range": [float(gpu[k].min()),
                                                         float(gpu[k].max())]}
        ok = ok and card <= allowed
    return out, ok


def new_path_spec(name):
    """(build(dtype, device), compared fields, start) of a new path's 3-step
    comparison: mima_gwd, continents_sst, or one of RAS_BL_STARTS' schemes
    on frierson_test_case_config(); start(model) is its initial state."""
    from isca_tpu_torch.models import cases
    from isca_tpu_torch.models.moist import GreyMoistModel

    cold = lambda model: model.initial_state()
    if name == "mima_gwd":
        return (lambda dtype, device: cases.add_mima_series(GreyMoistModel(
            cases.mima_gwd_config(dtype, transform_precision="highest"), device=device)),
            MIMA_GWD_FIELDS, cold)
    if name == "continents_sst":
        return (lambda dtype, device: continents_model(dtype, device, continents_sst=True),
                SST_FIELDS, cold)
    resolution = "T42" if name == "RAS" else BL_COMPARE_RESOLUTION
    fields = FR_FIELDS + (("klcl",) if name == "RAS" else ("z_pbl",))
    if name == "mellor_yamada":
        fields = fields + ("tke",)
    return (lambda dtype, device: GreyMoistModel(cases.ras_bl_config(
        dtype, name, resolution=resolution, transform_precision="highest"), device=device),
        fields, cases.convective_start if RAS_BL_STARTS[name] == "convective" else cold)


def cpu_reference(name, threads=CPU_REF_THREADS):
    """The CPU's float32 and float64 runs of a new path's comparison:
    {dtype name: (fields, convecting columns)}. Runs in a worker process of
    `threads` threads beside the card's earlier phases."""
    import warnings

    torch.set_num_threads(threads)
    build, fields, start = new_path_spec(name)
    out = {}
    with warnings.catch_warnings():
        # the committed RRTMG-LW k-tables are synthetic and say so
        warnings.simplefilter("ignore", RuntimeWarning)
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            model = build(dtype, "cpu")
            out[dname] = _diag_compare_run(model, start(model), fields)[:2]
    return out


def _new_path_compare(name, cpu_ref):
    """3 steps of a new path on the card against the CPU's (cpu_ref: a
    future of cpu_reference(name)) from the same start: the continuous
    fields by the 3x rule, CHOICE_FIELDS by the discrete-choice rule, and
    convection flips counted. Raises when either rule fails; returns
    (report, the card's state, its model)."""
    from isca_tpu_torch.physics import rrtmg_sw

    build, fields, start = new_path_spec(name)
    cont = tuple(k for k in fields if k not in CHOICE_FIELDS)
    choice = tuple(k for k in fields if k in CHOICE_FIELDS)
    t0 = time.perf_counter()
    cpu = cpu_ref.result()
    wait_s = time.perf_counter() - t0
    model = build(torch.float32, None)
    torch.cuda.synchronize()
    rrtmg_sw.sw_flux_solve.launches = 0
    gpu, gpu_conv, state = _diag_compare_run(model, start(model), fields)
    compare, ok = gap_compare(gpu, cpu["float32"][0], cpu["float64"][0], FR_TOL_FACTOR, cont)
    choices, ok_c = _choices(gpu, cpu["float32"][0], cpu["float64"][0], choice)
    flips = None
    if gpu_conv is not None:
        flips = {"card_vs_cpu_f32": int((gpu_conv != cpu["float32"][1]).sum()),
                 "cpu_f32_vs_f64": int((cpu["float32"][1] != cpu["float64"][1]).sum()),
                 "convecting_columns_cpu_f64": int(cpu["float64"][1].sum())}
    if not (ok and ok_c):
        raise RuntimeError(f"{name}: card and CPU runs disagree after {FR_COMPARE_STEPS} "
                           f"steps: {compare}; choices {choices}; convection flips {flips}")
    return {"compare_steps": FR_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
            "compare": compare, "choices": choices, "convection_flips": flips,
            "cpu_reference_wait_s": wait_s}, state, model


def _new_path_timed(name, model, state, stages, runs_n=FR_TIMED_RUNS):
    """NEW_WARMUP_STEPS warm-up steps from the test case's cold start, runs_n
    timed NEW_TIMED_STEPS-step runs, peak memory, 2 profiled steps. Returns
    the report and sw_flux's count before the profile."""
    from isca_tpu_torch.physics import rrtmg_sw

    state, warmup_s, runs = _timed_runs(model, state, NEW_WARMUP_STEPS, NEW_TIMED_STEPS,
                                        runs_n)
    torch.cuda.synchronize()
    launches = rrtmg_sw.sw_flux_solve.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_per_step = statistics.median(runs)
    t_range = _gcm_valid(name, model, state)
    kernels, device_ms, stage_rows, _ = profile_stages(model, state, MOIST_STAGES + stages)
    core = model.config.core
    return {"warmup_steps": NEW_WARMUP_STEPS, "warmup_s": warmup_s, "timed_runs": runs_n,
            "steps_per_run": NEW_TIMED_STEPS, "ms_per_step_runs": runs,
            "ms_per_step_median": ms_per_step,
            "value": core.dt / (ms_per_step * 1e-3), "unit": "model-days/day (one GPU)",
            "t_range": t_range, "peak_memory_mb": peak_mb, "profile_steps": 2,
            "device_ms_per_step": device_ms,
            "launches_per_step": sum(e.count for e in kernels) / 2,
            "idle_share": 1.0 - device_ms / ms_per_step, "stages": stage_rows}, launches


def phase_mima_gwd(cpu_refs):
    """MiMA with mima.nml's damping, the convective gravity-wave drag and
    seeded ozone and q-flux series (cases.mima_gwd_config) at T42L25:
    3 steps against the CPU, timed runs, sw_flux once per step. Returns the
    path's sw_flux launches."""
    import warnings

    t_phase = time.perf_counter()
    with warnings.catch_warnings():
        # the committed RRTMG-LW k-tables are synthetic and say so
        warnings.simplefilter("ignore", RuntimeWarning)
        report, state, model = _new_path_compare("mima_gwd", cpu_refs["mima_gwd"])
    if model.physics.radiation.lw_rrtmg is None or model.physics.cg_drag is None:
        raise RuntimeError("mima_gwd: RRTMG-LW or the convective drag is not on the path")
    state = model.initial_state()
    timed, launches = _new_path_timed("mima_gwd", model, state, ("rrtmg_lw", "cg_drag"))
    steps = FR_COMPARE_STEPS + NEW_WARMUP_STEPS + FR_TIMED_RUNS * NEW_TIMED_STEPS
    if launches != steps:
        raise RuntimeError(f"mima_gwd: sw_flux launched {launches} times in {steps} steps, "
                           "expected one per step")
    o3 = model.physics.radiation.o3_field
    core, T = model.config.core, model.core.T
    emit({"phase": "mima_gwd", "model": "mima_test_case + mima.nml damping + cg_drag + "
          "ozone and q-flux series", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "levels": core.num_levels, "dt": core.dt,
          "dtype": str(core.dtype), "transform_precision": core.transform_precision,
          "width": "full: mima_test_case.py's T42L25; nothing cut", **report,
          "metric": "mima_gwd_T42L25_model_days_per_day", **timed,
          "o3_range": [float(o3.min()), float(o3.max())],
          "sw_flux_launches": launches, "steps": steps,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def phase_continents_sst(cpu_refs):
    """The realistic continents with prescribed ocean SSTs, sea ice and the
    orographic drag at T42L25: 3 steps against the CPU, the ocean pinned to
    the SST series and the land not, timed runs. Returns its sw_flux
    launches."""

    t_phase = time.perf_counter()
    report, state, model = _new_path_compare("continents_sst", cpu_refs["continents_sst"])
    land = (model.land_mask > 0.5).cpu().numpy()
    sst = model.physics.sst_series.at(state.time_seconds - model.config.core.dt)
    gap = (state.t_surf - sst).abs().cpu().numpy()
    pinned = {"ocean_max_abs_k": float(gap[~land].max()), "land_max_abs_k": float(gap[land].max())}
    if pinned["ocean_max_abs_k"] > 1e-3 or pinned["land_max_abs_k"] < 0.1:
        raise RuntimeError(f"continents_sst: the ocean is not pinned to the SSTs or the land "
                           f"is: {pinned}")
    timed, launches = _new_path_timed("continents_sst", model, model.initial_state(),
                                      ("mg_drag",))
    if launches:
        raise RuntimeError(f"continents_sst: sw_flux launched {launches} times off its path")
    core, T = model.config.core, model.core.T
    emit({"phase": "continents_sst", "model": "realistic_continents + do_sc_sst "
          "(ocean only) + sea-ice albedo + mg_drag", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "levels": core.num_levels, "dt": core.dt,
          "dtype": str(core.dtype), "land_fraction": float(land.mean()),
          "width": "full: realistic_continents_test_case.py's T42L25; nothing cut",
          **report, "t_surf_minus_sst": pinned,
          "metric": "continents_sst_T42L25_model_days_per_day", **timed,
          "sw_flux_launches": launches, "phase_seconds": time.perf_counter() - t_phase})
    return launches


def phase_ras_bl(cpu_refs):
    """frierson_test_case_config() with RAS (3 steps against the CPU, three
    timed runs), then with simple Betts-Miller and each of the MY2.5, EDT,
    entrain and stable-BL (with shallow convection) schemes (3 steps against
    the CPU at BL_COMPARE_RESOLUTION, one timed run at T42L25), each
    profiled. Returns their sw_flux launches."""
    from isca_tpu_torch.models import cases
    from isca_tpu_torch.models.moist import GreyMoistModel

    total = 0
    for scheme in RAS_BL_STARTS:
        t_phase = time.perf_counter()
        report, state, model = _new_path_compare(f"{scheme}", cpu_refs[scheme])
        if scheme != "RAS":
            model = GreyMoistModel(cases.ras_bl_config(torch.float32, scheme,
                                                       transform_precision="highest"))
        timed, launches = _new_path_timed(
            f"ras_bl {scheme}", model, model.initial_state(), RAS_BL_STAGES[scheme],
            FR_TIMED_RUNS if scheme == "RAS" else 1)
        if launches:
            raise RuntimeError(f"ras_bl {scheme}: sw_flux launched {launches} times off "
                               "its path")
        total += launches
        core = model.config.core
        stem = "ras" if scheme == "RAS" else f"frierson_{scheme}"
        emit({"phase": "ras_bl", "scheme": scheme, "model": "frierson_test_case with "
              + ("RAS" if scheme == "RAS" else f"bl_scheme={scheme}"
                 + (" + shallow_conv" if scheme == "stable_bl" else "")),
              "resolution": core.resolution, "levels": core.num_levels, "dt": core.dt,
              "dtype": str(core.dtype), "compare_start": RAS_BL_STARTS[scheme],
              "compare_resolution": ("T42" if scheme == "RAS" else BL_COMPARE_RESOLUTION)
              + "L25",
              "width": "full: frierson_test_case.py's T42L25; nothing cut", **report,
              "metric": f"{stem}_T42L25_model_days_per_day", **timed,
              "sw_flux_launches": launches, "phase_seconds": time.perf_counter() - t_phase})
    return total


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


# ---------------------------------------------------------------------------
# sharded: the port's mesh path, ranks spawned on the card
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2
SHARDED_TIMED_STEPS = 10
SHARDED_MODELS = {"held_suarez": HS_FIELDS, "frierson": FR_FIELDS}


def _sharded_model(name, mesh):
    """The `dycore` or `moist` model at float32 on the mesh."""
    from isca_tpu_torch.models.dry import HeldSuarezModel
    from isca_tpu_torch.models.moist import GreyMoistModel

    cfg = hs_config(torch.float32) if name == "held_suarez" else frierson_config(torch.float32)
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, mesh=mesh))
    return HeldSuarezModel(cfg) if name == "held_suarez" else GreyMoistModel(cfg)


@contextlib.contextmanager
def _timed_collectives(names=("all_to_all_single", "all_reduce")):
    """While open, each call of the named torch.distributed functions waits
    for the card before and for its own end after, and adds its host time
    to acc[name] = [calls, seconds]."""
    import torch.distributed as dist

    acc = {n: [0, 0.0] for n in names}
    originals = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = originals[name](*args, **kwargs)
            if work is not None:
                work.wait()
            torch.cuda.synchronize()
            acc[name][0] += 1
            acc[name][1] += time.perf_counter() - t0
            return work
        return timed

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield acc
    finally:
        for n, f in originals.items():
            setattr(dist, n, f)


def _sharded_steps(model, state, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.run(state, steps, first=False)
    torch.cuda.synchronize()
    return state, 1e3 * (time.perf_counter() - t0) / steps


def sharded_rank(rank, outdir):
    """One rank of `sharded` (spawned): each model 3 steps on the mesh, its
    gathered fields (rank 0 writes them), its blocks, the HS tile restart,
    the timed runs; the rank's report in outdir/rank<r>.json."""
    import torch.distributed as dist
    from isca_tpu_torch.io import distributed as dio
    from isca_tpu_torch.io.restart import load_restart
    from isca_tpu_torch.parallel.mesh import gather_pytree, make_mesh
    from isca_tpu_torch.physics import rrtmg_sw
    from isca_tpu_torch.utils.tree import flatten_with_paths

    mesh = make_mesh(SHARDED_RANKS)
    report = {"rank": rank, "device": str(mesh.device), "backend": mesh.backend}
    for name, fields in SHARDED_MODELS.items():
        model = _sharded_model(name, mesh)
        T = model.core.T
        state = model.run(model.initial_state(), HS_COMPARE_STEPS)
        got = gather_pytree(mesh, {k: v for k, v in model.diag_fields(state).items()
                                   if k in fields}, nlat=T.nlat)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{name}.npz"),
                     **{k: v.cpu().numpy().astype(np.float64) for k, v in got.items()})
        dyn = state if name == "held_suarez" else state.dyn
        blocks = mesh.all_gather(dyn.ts.curr[None], 0)
        rep = {"m_rows": [T.m_start, T.m_start + T.spec_shape[0]],
               "lat_rows": [T.lat_start, T.lat_start + T.grid_shape[0]],
               "m_blocks_distinct": not torch.equal(blocks[0], blocks[1])}
        dist.barrier()
        state, rep["ms_per_step"] = _sharded_steps(model, state, SHARDED_TIMED_STEPS)
        dist.barrier()
        with _timed_collectives() as acc:
            state, rep["instrumented_ms_per_step"] = _sharded_steps(
                model, state, SHARDED_TIMED_STEPS)
        for n, (calls, seconds) in acc.items():
            rep[n] = {"calls_per_step": calls / SHARDED_TIMED_STEPS,
                      "ms_per_step": 1e3 * seconds / SHARDED_TIMED_STEPS,
                      "share_of_instrumented_step":
                          1e3 * seconds / SHARDED_TIMED_STEPS / rep["instrumented_ms_per_step"]}
        if name == "held_suarez":
            tiles = os.path.join(outdir, "tiles")
            dio.save_restart_sharded(tiles, state, mesh, nlat=T.nlat)
            dist.barrier()
            loaded = dio.load_restart_sharded(tiles, model.initial_state(), mesh)
            rep["tile_blocks_bit_equal"] = all(
                a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in
                zip(flatten_with_paths(state), flatten_with_paths(loaded)))
            whole = gather_pytree(mesh, state, nlat=T.nlat)
            if rank == 0:
                combined = os.path.join(outdir, "combined.npz")
                dio.combine_restart_tiles(tiles, combined)
                back = load_restart(combined, whole)
                rep["combined_bit_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in
                    zip(flatten_with_paths(whole), flatten_with_paths(back)))
                rep["tile_mb"] = sum(os.path.getsize(os.path.join(tiles, f))
                                     for f in os.listdir(tiles)) / 2**20
        report[name] = rep
    report["sw_flux_launches"] = getattr(rrtmg_sw.sw_flux_solve, "launches", 0)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _sharded_run(backend):
    """Spawn the ranks over `backend`, check what they wrote; the report."""
    import tempfile

    from isca_tpu_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(sharded_rank, SHARDED_RANKS, backend, os.path.join(tmp, "init"), args=(tmp,))
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        out = {"backend": backend, "ranks": SHARDED_RANKS,
               "devices": [r["device"] for r in ranks],
               "backends": [r["backend"] for r in ranks],
               "sw_flux_launches": sum(r["sw_flux_launches"] for r in ranks)}
        failures = []
        for name, fields in SHARDED_MODELS.items():
            with np.load(os.path.join(tmp, f"{name}.npz")) as data:
                got = {k: data[k] for k in fields}
            card, cpu32, cpu64 = COMPARE_REFS[name]
            compare, ok = gap_compare(got, cpu32, cpu64, HS_TOL_FACTOR, fields)
            rows = [r[name]["m_rows"] for r in ranks]
            model = {"compare_steps": HS_COMPARE_STEPS, "tolerance_factor": HS_TOL_FACTOR,
                     "compare": compare,
                     "sharded_vs_one_card": {k: float(np.abs(got[k] - card[k]).max())
                                             for k in fields},
                     "m_rows": rows, "lat_rows": [r[name]["lat_rows"] for r in ranks],
                     "ranks": [{k: v for k, v in r[name].items()
                                if k not in ("m_rows", "lat_rows")} for r in ranks]}
            if not ok:
                failures.append(f"{name}: the sharded fields break the 3x rule: {compare}")
            if len({tuple(x) for x in rows}) != SHARDED_RANKS or not all(
                    r[name]["m_blocks_distinct"] for r in ranks):
                failures.append(f"{name}: the ranks' m blocks are not distinct: {rows}")
            out[name] = model
        hs = [r["held_suarez"] for r in ranks]
        if not (all(h["tile_blocks_bit_equal"] for h in hs) and hs[0]["combined_bit_equal"]):
            failures.append(f"held_suarez: the tile restart did not load back bit-equal: {hs}")
        if out["sw_flux_launches"] != 0:
            failures.append(f"sw_flux launched {out['sw_flux_launches']} times")
    out["phase_seconds"] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("sharded: " + "; ".join(failures))
    return out


def phase_sharded(smi):
    """The sharded phase: gloo on this card; NCCL when there are two cards."""
    torch.cuda.empty_cache()
    emit({"phase": "sharded", "what": "correctness run of ranks sharing one card over "
          "gloo (staged through the host): not a scaling number", "nvidia_smi": smi,
          **_sharded_run("gloo")})
    if torch.cuda.device_count() >= 2:
        emit({"phase": "sharded", "what": "ranks on their own cards over NCCL",
              "nvidia_smi": smi, **_sharded_run("nccl")})
    else:
        emit({"phase": "sharded", "backend": "nccl",
              "not_run": f"torch.cuda.device_count() is {torch.cuda.device_count()}: "
                         "NCCL needs one card per rank"})


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
    pool = ProcessPoolExecutor(max_workers=CPU_REF_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_refs = {name: pool.submit(cpu_reference, name) for name in NEW_PATHS}
        return _run_phases(kind, smi, cpu_refs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _run_phases(kind, smi, cpu_refs):
    """Every phase after the build, in order; the kernels summary, the
    nvidia-smi line and the last line."""
    cases = phase_kernels()
    launches, model, state, ms_per_step = phase_slice()
    phase_profile(model, state, ms_per_step)
    hs_model, hs_state, hs_ms = phase_dycore()
    phase_dycore_profile(hs_model, hs_state, hs_ms)
    fr_model, fr_state, fr_ms = phase_moist()
    phase_moist_profile(fr_model, fr_state, fr_ms)
    rrtm_launches = phase_moist_rrtm()
    mima_launches = {"mima": phase_mima(), "mima_dt_rad": phase_mima_dt_rad()}
    cloud_launches = {name: phase_cloud_gcm(name) for name in CLOUD_PHASES}
    new_paths = {**phase_simple(), **phase_giant(), **phase_moist_land()}
    new_paths.update(mima_gwd=phase_mima_gwd(cpu_refs),
                     continents_sst=phase_continents_sst(cpu_refs),
                     ras_bl=phase_ras_bl(cpu_refs))
    exp_launches = phase_experiment(hs_model, hs_ms, fr_model, fr_ms)
    phase_sharded(smi)
    main_case = cases[0]                      # the main path's shape and variant
    emit({"kernels": [{
        "name": "sw_flux", "route": "cuda",
        "source": "isca_tpu_torch/csrc/sw_flux.cu",
        "replaces": "isca_tpu/physics/rrtmg_sw.py:782",
        "launches": launches["sw_flux"],
        "launches_by_path": {"slice": launches["sw_flux"], "moist_rrtm": rrtm_launches,
                             **mima_launches, **cloud_launches,
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
