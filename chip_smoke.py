#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   the card's name and `nvidia-smi` name and power limit;
  build    compiles every kernel under isca_tpu_torch/csrc (nvcc, sm_90a) and
           reports the time and the compiler's register/spill lines;
  kernels  holds each kernel against its plain PyTorch version on the card,
           on seeded random inputs at the shapes of the main paths (sw_flux:
           8192 x 25 x 112 for RRTMG-SW, 8192 x 25 x 28 for SOCRATES,
           8192 x 40 x 112 for the namelist MiMA and 4096 x 25 x 112 for one
           of 2 ranks' bands at T42, clear and cloudy; and past its former
           limits, 8192 x 80 x 112, 8192 x 128 x 112, 8192 x 25 x 256 and
           float64 2048 x 100 x 112; tf32_product, the "high" and "default"
           transform products on the tensor cores, at the four products of
           HS T85L25 and the giant's T213L30, 3 fields of all levels, both
           modes, rank 1 of 2's m block and latitude band at T85L25, the
           ragged T42L25, and with positive operands, whose mean signed
           error shows the tensor cores' sums, within PRECISION_ULPS) and at
           an odd shape, times both (sw_flux with CUDA events, tf32_product
           by its device time under torch.profiler beside the exact and, at
           "default", the TF32 cuBLAS product), and reports sw_flux's launch
           plan and resident blocks per SM;
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
           100, float32): 3 steps kept for `giant_t213_compare` (the CPU's
           T213L30 runs are a cpu_reference job), 1 more warm-up step, three
           timed 10-step runs, median ms per step,
           giant_T213L30_model_days_per_day, launches per step, idle share,
           peak memory.
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
  namelist exp/namelists/mima.nml built through isca_tpu_torch.namelist on
           the card at float32, "highest": T42L40, dt = 600 s, RRTM with
           dt_rad = 7200 s (n_rad = 12), simple Betts-Miller, q-flux, a
           100 m slab. 3 steps against the CPU's float32 and float64 runs (a
           cpu_reference job) by the 3x rule, then 12 steps timed one by one
           (step 13 the radiation step), sw_flux at steps 1 and 13;
           held_suarez.nml (at the `dycore` phase's T85) and frierson.nml
           built through the reader and compared field by field with the
           `dycore` and `moist` phases' configurations: the namelists are
           transcriptions that differ from them in the fields named in
           NAMELIST_PHASE_DIFFS, which must be exactly those, each with the
           namelist's value given there.
  giant_t213_compare
           the `giant` phase's 3 T213L30 card steps against the CPU's
           float32 and float64 runs (a cpu_reference job) by the 3x rule;
           `sharded` then holds its T213L30 giant to the same CPU runs.
  precision
           transform_precision "high" (3xTF32) and "default" (one TF32
           pass), spectral/precision.py: each transform product (DFT and
           Legendre, analysis and synthesis) at T85L25 and T213L30 shapes
           on the card against the plain version of the same mode on the
           CPU (within PRECISION_ULPS x sqrt(K') units of FP32 rounding of
           |x||table|, plus the subnormal operands the tensor cores flush;
           random inputs and a smooth positive one, whose
           mean signed error shows the tensor cores' round-toward-zero
           sums), with its largest difference from "highest"; HS T85L25 3
           steps at each mode against the CPU's run of that mode: the 3x
           rule at the mode's own CPU gap reported per field (it fails at
           "high", see PERF.md), 3x the larger of the CPU's float32-versus-
           float64 gaps at that mode and at exact FP32 asserted, and the run
           not equal to "highest"'s (tf32_product's launches counted in the
           "high" run: the main path), then one timed day per mode and 2
           profiled steps (launches per step by mode, the "dft" and
           "legendre" device ms); the giant T213L30 and MiMA T42L25
           (sw_flux once per step) 3 steps at "high" against the card's
           "highest" within HIGH_VS_HIGHEST_FACTOR x the CPU's own float32-
           versus-float64 gap; ms per step by mode for HS and the giant and
           the giant's "dft" and "legendre" device ms by mode; the cuBLAS
           TF32 switch off after every call; every "highest" run equal to
           its earlier phase's to the bit; the port's climate gate
           (isca_tpu_torch.climate_gate) for Held-Suarez at T42 "high" with
           its fewest steps (2 x 256), its criteria printed, not asserted.
  sharded  the sharded run (isca_tpu_torch.parallel.mesh): 2 ranks spawned
           on the one card over gloo, which stages its collectives through
           the host. Every model isca_tpu shards, each the configuration of
           its single-card phase with a mesh: HS T85L25, Frierson T42L25,
           MiMA T42L25 (sw_flux on each rank's 32 x 128 columns), the
           SOCRATES aquaplanet with clouds T42L25 (moist start), the
           realistic continents with topography and the bucket, and
           continents_sst with its series and mg_drag (the land, the
           topography and the series built on the whole globe, each rank
           keeping its band), the giant planet T213L30 and shallow water
           T85; float32, 3 steps sharded from cold start, the gathered
           fields held by the 3x rule against the single-card phases' CPU
           runs (COMPARE_REFS; the giant's those of giant_t213_compare)
           and compared with those phases' 3 card
           steps on one device; each rank's m rows and its spectral block
           distinct; each rank's sw_flux launches (one per step for MiMA
           and SOCRATES, 0 for the others); HS and MiMA tile restarts
           written by both ranks, read back into each rank's blocks and
           combined into one file, all bit-equal; 5 timed steps (ms per
           step), then 5 with every all_to_all and all_reduce synchronised
           and timed (their share of that step). A correctness run on one
           card, not a scaling number. With two or more cards the same
           again over NCCL, one card per rank; with one, a line says so.
The CPU's float32 and float64 runs that simple_clouds, mima_gwd,
continents_sst, ras_bl, namelist and giant_t213_compare compare with are
made by two worker processes (`cpu_reference`: simple_clouds' first, on four
threads, the others on two), started after the build, so that they run
beside the earlier phases; the earlier phases' card timings share the host
with them.
The two mima phases run after `moist_rrtm`, then the three cloud and
SOCRATES phases, then simple, giant, moist_land, mima_gwd, continents_sst
and ras_bl; sw_flux must not launch on the paths of simple, giant,
moist_land, continents_sst and ras_bl (its count on each is printed). `experiment` also runs the stirred
barotropic model in two chained one-day segments, held to the bit (the
stirring key too) against one direct two-day run. `namelist`,
`giant_t213_compare`, `precision` and `sharded` run last. Then a `summary` line with each phase's seconds, the
`{"kernels": [...]}` summary line (sw_flux with its launches_by_path: each
path's count, the sharded models' per rank; tf32_product with the `precision`
phase's HS "high" count and its giant and MiMA "high" counts), the raw `nvidia-smi` name and
power limit line, and last `{"ok": true, "device": {...}}`. Any failed phase
raises, so the script exits non-zero and prints no last line; so does a run
without a CUDA device.
"""

from __future__ import annotations

import bisect
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
PEAK_TF32_PER_S = 495e12      # the tensor cores, dense

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


def device_ms(fn, reps=20, warmup=3, tries=3, launches=None):
    """Device ms per fn() call: the card's kernel time under torch.profiler
    over `reps` calls, which leaves out the host's time between them. A
    profile that comes back without device time, or with other than
    `launches` kernel launches a call where the caller knows them, is taken
    again (the profiler's device records went missing now and then on the
    card's machine)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        count = sum(e.count for e in rows)
        if rows and (launches is None or count == launches * reps):
            return sum(e.self_device_time_total for e in rows) / 1e3 / reps
    raise RuntimeError(f"device_ms: the profiler saw no device time, or not "
                       f"{launches} launches a call, in {tries} tries")


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


def sw_flux_inputs(batch, L, cloudy, device, G=112, seed=SEED, dtype=np.float32):
    """Random solve inputs from the distributions of tests/test_rrtmg_sw.py
    _inputs (optical depths gamma(1.5, 0.08), gamma(2, 2) more in a cloud,
    the rest uniform), drawn on `device` from a seeded torch generator: a
    host draw of the largest shapes took most of the `kernels` phase."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    new = lambda shape: torch.empty(shape, dtype=tdtype, device=device)
    u = lambda lo, hi, shape: new(shape).uniform_(lo, hi, generator=gen)
    gamma = lambda k, theta, shape: theta * torch._standard_gamma(new(shape).fill_(k),
                                                                  generator=gen)
    layer = batch + (L, G)
    tau = gamma(1.5, 0.08, layer)
    zinc = u(0.0, 12.0, batch + (G,))
    zinc[..., ::7] = 0.0                      # some g-points carry no flux
    args = [tau, u(0.0, 1.0, layer), u(0.0, 0.8, layer), u(0.05, 1.0, batch + (1, 1)),
            u(0.05, 0.6, batch + (G,)), u(0.05, 0.6, batch + (G,)), zinc]
    cloud = None
    if cloudy:
        cloud = (tau + gamma(2.0, 2.0, layer), u(0.3, 1.0, layer), u(0.0, 0.9, layer),
                 u(0.0, 1.0, layer))
    return args, cloud


def sw_flux_bound_ms(B, L, G, cloudy, itemsize=4):
    """Least time on the card: each input read once and each output written
    once over the memory rate, or the operations over the FP32 rate."""
    n_layer_arrays = 7 if cloudy else 3
    nbytes = itemsize * (n_layer_arrays * B * L * G + B + 3 * B * G + 3 * B * (L + 1))
    ops = SW_FLUX_OPS_PER_ELEMENT[cloudy] * B * L * G
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_sw_flux(name, batch, L, cloudy, G=112, dtype=np.float32, reps=20):
    """Kernel against sw_flux_solve_reference on the card, both timed (the
    median of `reps` runs), at batch x L x G (G = 112 for RRTMG-SW, 28 for
    SOCRATES' SW spectrum)."""
    from isca_tpu_torch.physics import rrtmg_sw

    args, cloud = sw_flux_inputs(batch, L, cloudy, "cuda", G=G, dtype=dtype)
    kernel = lambda: rrtmg_sw.sw_flux_solve(*args, cloud=cloud)
    plain = lambda: rrtmg_sw.sw_flux_solve_reference(*args, cloud=cloud)
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    # tests/test_rrtmg_sw.py's float32 tolerance for the fused solve:
    # reassociated float32 sums over G and L differ by ~1e-4 relative; in
    # float64 the same reassociation, tests/test_torch_card.py's 1e-10.
    scale = float(ref[0].abs().max())
    rtol, atol = (5e-4, 1e-4 * scale) if dtype == np.float32 else (1e-10, 1e-12 * scale)
    errs, ok = {}, True
    for a, b, field in zip(out, ref, ("swd", "swu", "dird")):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"sw_flux {name}: non-finite {field}")
        excess = ((a - b).abs() - (atol + rtol * b.abs())).max().item()
        errs[field] = float((a - b).abs().max())
        ok = ok and excess <= 0.0
    B = int(np.prod(batch))
    itemsize = np.dtype(dtype).itemsize
    bound_ms, bound_by = sw_flux_bound_ms(B, L, G, cloudy, itemsize)
    plan = rrtmg_sw.sw_flux_plan(L, G, itemsize)
    case = dict(case=name, shape=[B, L, G], dtype=np.dtype(dtype).name, cloudy=cloudy,
                plan=plan._asdict(),
                blocks_per_sm=rrtmg_sw.sw_flux_blocks_per_sm(L, G, args[0].dtype, cloudy),
                max_abs_err=max(errs.values()), errs=errs, rtol=rtol, atol=atol,
                ms=cuda_time_ms(kernel, reps=reps),
                plain_ms=cuda_time_ms(plain, reps=reps),
                bound_ms=bound_ms, bound_us=1e3 * bound_ms, bound_by=bound_by, ok=ok)
    emit({"phase": "kernels", "kernel": "sw_flux", **case})
    if not ok:
        raise RuntimeError(f"sw_flux {name}: kernel disagrees with its plain "
                           f"version beyond rtol={rtol}, atol={atol}: {errs}")
    return case


def phase_kernels():
    """Each kernel against its plain version: (sw_flux cases, tf32_product
    cases), the main path's case first in each."""
    return sw_flux_cases(), tf32_product_cases()


def sw_flux_cases():
    return [check_sw_flux("t42_clear", (8192,), 25, False),
            check_sw_flux("t42_cloudy", (8192,), 25, True),
            # the namelist MiMA (T42L40) and one of 2 ranks' bands at T42L25
            check_sw_flux("mima_nml_t42l40_clear", (8192,), 40, False),
            check_sw_flux("mima_nml_t42l40_cloudy", (8192,), 40, True),
            check_sw_flux("rank_band_clear", (4096,), 25, False),
            check_sw_flux("rank_band_cloudy", (4096,), 25, True),
            check_sw_flux("socrates_clear", (8192,), 25, False, G=SOCRATES_G),
            check_sw_flux("socrates_cloudy", (8192,), 25, True, G=SOCRATES_G),
            check_sw_flux("odd_clear", (7,), 5, False),
            check_sw_flux("odd_cloudy", (7,), 5, True),
            # deeper and wider than any path yet: L + 1 beyond the threads'
            # levels is looped, G beyond a block's threads is chunked
            *(check_sw_flux(f"L{L}_G{G}_{'cloudy' if c else 'clear'}", (8192,), L, c, G=G,
                            reps=SW_FLUX_NEW_REPS)
              for L, G in SW_FLUX_NEW_SHAPES for c in (False, True)),
            *(check_sw_flux(f"f64_L100_{'cloudy' if c else 'clear'}", (2048,), 100, c,
                            dtype=np.float64, reps=SW_FLUX_NEW_REPS) for c in (False, True))]


# sw_flux shapes past the kernel's former limits (L <= 64, G <= 128)
SW_FLUX_NEW_SHAPES = ((80, 112), (128, 112), (25, 256))
SW_FLUX_NEW_REPS = 5      # their plain version takes up to 170 ms a call


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


def hs_config(dtype, precision="highest"):
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.models.dry import HeldSuarezConfig
    from isca_tpu_torch.physics.hs_forcing import HSForcingConfig

    return HeldSuarezConfig(
        core=PrimitiveConfig(resolution="T85", num_levels=25, dt=600.0,
                             transform_precision=precision, dtype=dtype),
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


def _within(spans, t):
    """Whether t lies in one of `spans`, a sorted list of (start, end)."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


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
    # a kernel counts in a range when it starts within the range's span on
    # the card (one stream: the kernels launched inside the range on the
    # host), which also finds the port's own kernels: launched through
    # ctypes, they have no ATen op in the trace
    stages, spans, device_kernels = {}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
            else:
                device_kernels.append(e)
        elif e.name in stage_names:
            stages.setdefault(e.name, {"calls": 0, "kernels": {}})["calls"] += 1
    for name, st in stages.items():
        within = sorted(spans.get(name, ()))
        for k in device_kernels:
            if _within(within, k.time_range.start):
                row = st["kernels"].setdefault(k.name[:80], [0, 0.0])
                row[0] += 1
                row[1] += k.time_range.elapsed_us()
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

# 3 timed runs of 10 steps keep the whole script well inside its time limit
FR_COMPARE_STEPS, FR_WARMUP_STEPS, FR_TIMED_STEPS, FR_TIMED_RUNS = 3, 6, 10, 3
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


def mima_config(dtype, dt_rad=0.0, precision="highest"):
    """mima_test_case.py as written (GreyMoistConfig(): T42, 25 uneven-sigma
    levels, dt = 720 s; RRTMG-SW + RRTMG-LW, seasonal sun, o3 1e-6; full
    Betts-Miller) with exact transforms (or `precision`'s); dt_rad > dt
    substeps radiation."""
    from isca_tpu_torch.models.moist import mima_test_case_config

    cfg = mima_test_case_config(dtype=dtype, transform_precision=precision)
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
    COMPARE_REFS["mima"] = (gpu, cpu["float32"][0], cpu["float64"][0])
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


# the cloud phases whose CPU float32 and float64 moist-start runs are a
# cpu_reference job (the threads it gets): simple_clouds' (RRTMG-LW's cloudy
# sweeps at T42L25) are the script's longest CPU runs, submitted first
CLOUD_CPU_REFS = {"simple_clouds": 4}


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


def cloud_cpu_runs(name):
    """The CPU's float32 and float64 runs of a cloud phase's comparison."""
    from isca_tpu_torch.models.moist import GreyMoistModel

    return tuple(_cloud_compare_run(GreyMoistModel(
        cloud_phase_config(name, dtype, moist_start=True), device="cpu"))
        for dtype in (torch.float32, torch.float64))


def phase_cloud_gcm(name, cpu_refs):
    """One of CLOUD_PHASES on the card: 3 moist-start steps against the CPU
    (its runs a cpu_reference job where CLOUD_CPU_REFS names the phase) by
    the 3x rule, then the test case as written: CLOUD_WARMUP_STEPS steps,
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
        if name in cpu_refs:
            cpu = cpu_refs[name].result()
            cpu32, cpu64 = cpu["float32"][0], cpu["float64"][0]
        else:
            cpu32, cpu64 = cloud_cpu_runs(name)
        wait_s = time.perf_counter() - t_phase
        torch.cuda.synchronize()
        rrtmg_sw.sw_flux_solve.launches = 0
        gpu = _cloud_compare_run(GreyMoistModel(
            cloud_phase_config(name, torch.float32, moist_start=True)))
        model = GreyMoistModel(cloud_phase_config(name, torch.float32))
    torch.cuda.synchronize()
    compare, ok = gap_compare(gpu, cpu32, cpu64, FR_TOL_FACTOR, tuple(gpu))
    COMPARE_REFS[name] = (gpu, cpu32, cpu64)
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
          "compare_cpu_runs_s": wait_s,
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
    COMPARE_REFS[kind] = (gpu, cpu["float32"][0], cpu["float64"][0])
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
    # the T213L30 card fields after 3 steps, which `giant_t213_compare`
    # holds to the CPU's (cpu_reference "giant_t213") and `sharded` to its own
    big, state = _diag_compare_run(model, model.initial_state(), GIANT_FIELDS)[::2]
    COMPARE_REFS["giant"] = big
    state, warmup_s, runs = _timed_runs(model, state, GIANT_WARMUP_STEPS - GIANT_COMPARE_STEPS,
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
          "compare_at": "giant_planet_model() defaults, T42L30 (T213L30 in the "
                        "giant_t213_compare phase)",
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


def continents_model(dtype, device=None, continents_sst=False, mesh=None):
    """exp/test_cases/realistic_continents_test_case.py: GreyMoistConfig()
    (T42L25, dt = 720 s) with the bucket, the idealized continents and the
    Sauliere 2012 topography band-limited through the model's truncation;
    continents_sst adds cases.py's prescribed ocean SSTs, sea ice and
    orographic drag (hprime 300 m over land). On `mesh` every field is
    built on the whole globe and each rank keeps its band."""
    from isca_tpu_torch.models import cases
    from isca_tpu_torch.models.moist import GreyMoistModel

    return cases.set_continents(GreyMoistModel(cases.continents_config(
        dtype, continents_sst, transform_precision="highest", mesh=mesh), device=device))


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
    COMPARE_REFS["continents"] = (gpu, cpu["float32"], cpu["float64"])
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
# the CPU runs of the `namelist` phase and of the giant's T213L30
# (giant_t213_compare), submitted after NEW_PATHS' (they are needed last)
LATE_CPU_REFS = ("namelist_mima", "giant_t213")
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
    if name == "giant_t213":
        from isca_tpu_torch.models.giant import giant_planet_model
        return (lambda dtype, device: giant_planet_model(dtype=dtype, device=device,
                                                         **GIANT_BIG), GIANT_FIELDS, cold)
    if name == "namelist_mima":
        return namelist_model, MIMA_FIELDS, cold
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
    """The CPU's float32 and float64 runs of a new path's or a cloud
    phase's comparison: {dtype name: (fields, convecting columns or None)}.
    Runs in a worker process of `threads` threads beside the card's earlier
    phases."""
    import warnings

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out = {}
    with warnings.catch_warnings():
        # the committed RRTMG-LW k-tables are synthetic and say so
        warnings.simplefilter("ignore", RuntimeWarning)
        if name in CLOUD_PHASES:
            out["float32"], out["float64"] = ((f, None) for f in cloud_cpu_runs(name))
        else:
            build, fields, start = new_path_spec(name)
            for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
                model = build(dtype, "cpu")
                out[dname] = _diag_compare_run(model, start(model), fields)[:2]
    out["seconds"] = time.perf_counter() - t0
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
    COMPARE_REFS[name] = (gpu, cpu["float32"][0], cpu["float64"][0])
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
# namelist: exp/namelists/mima.nml through the port's namelist reader
# ---------------------------------------------------------------------------

NAMELIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exp", "namelists")
# steps 4-15 after the 3 compared: mima.nml's dt_rad = 7200 s at dt = 600 s
# is n_rad = 12, so step 13 computes radiation and the others reuse it
NAMELIST_TIMED_STEPS = 12
# The reference namelists are transcriptions of the test cases' namelist
# dicts; the `dycore` and `moist` phases run bench.py's HS configuration and
# frierson_test_case_config(). Built through the reader (HS at the `dycore`
# phase's T85, both at float32) they differ from those in exactly these
# fields, each with the namelist's value here (its repr), which the phase
# checks and prints beside the phase's value.
UNEVEN_SIGMA = "(('scale_heights', 6.0), ('surf_res', 0.5), ('exponent', 7.5))"
NAMELIST_PHASE_DIFFS = {
    "held_suarez.nml": {".core.vert_coord_option": "'uneven_sigma'",
                        ".core.vert_coord_kwargs": UNEVEN_SIGMA,
                        ".core.reference_sea_level_press": "100000.0",
                        ".core.damping_order": "4",
                        ".core.water_correction_limit": "20000.0",
                        ".core.valid_range_t": "(100.0, 800.0)"},
    "frierson.nml": {".core.vert_coord_option": "'uneven_sigma'",
                     ".core.vert_coord_kwargs": UNEVEN_SIGMA,
                     ".physics.surface.use_virtual_temp": "False",
                     ".physics.surface.do_simple": "True",
                     ".physics.betts_miller.rhbm": "0.7"},
}


def read_namelist(name):
    from isca_tpu_torch.namelist import parse_namelist

    with open(os.path.join(NAMELIST_DIR, name)) as f:
        return parse_namelist(f.read())


def namelist_model(dtype, device=None, name="mima.nml", **overrides):
    """The model of a reference namelist through isca_tpu_torch.namelist at
    `dtype` with exact transforms (mima.nml: T42L40, dt = 600 s, RRTM with
    dt_rad = 7200 s, simple Betts-Miller, q-flux, a 100 m slab)."""
    from isca_tpu_torch.namelist import model_from_namelist

    return model_from_namelist(read_namelist(name), device=device, dtype=dtype,
                               transform_precision="highest", **overrides)


def config_diffs(a, b, path=""):
    """{dotted path: (a's value, b's value)} of the fields in which two
    configurations differ, descending into nested dataclasses."""
    if dataclasses.is_dataclass(a) and type(a) is type(b):
        out = {}
        for f in dataclasses.fields(a):
            out.update(config_diffs(getattr(a, f.name), getattr(b, f.name),
                                    f"{path}.{f.name}"))
        return out
    return {} if a == b else {path: (repr(a), repr(b))}


def phase_namelist(cpu_refs):
    """mima.nml through the port's namelist reader on the card: 3 steps
    against the CPU by the 3x rule, NAMELIST_TIMED_STEPS steps timed one by
    one (step 13 the radiation step), sw_flux at steps 1 and 13; then
    held_suarez.nml and frierson.nml against the `dycore` and `moist`
    phases' configurations, field by field. Returns the path's launches."""
    import warnings

    from isca_tpu_torch.physics import rrtmg_sw

    t_phase = time.perf_counter()
    with warnings.catch_warnings():
        # the committed RRTMG-LW k-tables are synthetic and say so
        warnings.simplefilter("ignore", RuntimeWarning)
        report, state, model = _new_path_compare("namelist_mima", cpu_refs["namelist_mima"])
    core, pc, T = model.config.core, model.config.physics, model.core.T
    shape = (core.resolution, core.num_levels, core.dt, pc.radiation_scheme, pc.dt_rad)
    if shape != ("T42", 40, 600.0, "rrtm", 7200.0) or model.physics.radiation.lw_rrtmg is None:
        raise RuntimeError(f"namelist: mima.nml built {shape}, not T42L40 RRTM dt_rad 7200")
    compare_launches = rrtmg_sw.sw_flux_solve.launches
    step_ms, at = [], []
    for i in range(NAMELIST_TIMED_STEPS):
        before = rrtmg_sw.sw_flux_solve.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.step(state)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        at.extend([FR_COMPARE_STEPS + i + 1] * (rrtmg_sw.sw_flux_solve.launches - before))
    launches = rrtmg_sw.sw_flux_solve.launches
    t_range = _gcm_valid("namelist", model, state)
    if compare_launches != 1 or at != [13]:
        raise RuntimeError(f"namelist: sw_flux launched {compare_launches} times in the "
                           f"{FR_COMPARE_STEPS} compared steps and at steps {at} after, "
                           "expected once, then at step 13")
    configs = {}
    for name, (phase, reference, overrides) in {
            "held_suarez.nml": ("dycore", hs_config, {"resolution": "T85"}),
            "frierson.nml": ("moist", frierson_config, {})}.items():
        built = namelist_model(torch.float32, "cpu", name, **overrides).config
        diffs = config_diffs(built, reference(torch.float32))
        configs[name] = {"against": phase, "overrides": overrides, "diffs": diffs}
        got = {k: built_value for k, (built_value, _) in diffs.items()}
        if got != NAMELIST_PHASE_DIFFS[name]:
            raise RuntimeError(f"namelist: {name} differs from the {phase} phase's "
                               f"configuration in {got}, expected "
                               f"{NAMELIST_PHASE_DIFFS[name]}")
    timed = [ms for i, ms in enumerate(step_ms) if FR_COMPARE_STEPS + i + 1 not in at]
    emit({"phase": "namelist", "model": "exp/namelists/mima.nml through "
          "isca_tpu_torch.namelist", "resolution": core.resolution,
          "grid": [T.nlat, T.nlon], "levels": core.num_levels, "dt": core.dt,
          "dt_rad": pc.dt_rad, "dtype": str(core.dtype),
          "transform_precision": core.transform_precision,
          "width": "full: the reference namelist's T42L40; nothing cut", **report,
          "timed_steps": NAMELIST_TIMED_STEPS, "ms_per_step": step_ms,
          "radiation_step_ms": [step_ms[s - FR_COMPARE_STEPS - 1] for s in at],
          "ms_per_step_median_without_radiation": statistics.median(timed),
          "ms_per_step_mean": statistics.fmean(step_ms),
          "metric": "mima_nml_T42L40_model_days_per_day",
          "value": core.dt / (statistics.fmean(step_ms) * 1e-3),
          "unit": "model-days/day (one GPU), mean over one radiation interval",
          "sw_flux_at_steps": [1] + at, "sw_flux_launches": launches, "t_range": t_range,
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
          "configs": configs, "phase_seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# sharded: the port's mesh path, ranks spawned on the card
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2
SHARDED_TIMED_STEPS = 5
# every model isca_tpu shards: name -> the fields compared after
# HS_COMPARE_STEPS steps with the single-card phase's CPU runs (COMPARE_REFS)
SHARDED_MODELS = {"held_suarez": HS_FIELDS, "frierson": FR_FIELDS,
                  "mima": MIMA_FIELDS, "socrates_cloud": FR_FIELDS + ("olr", "cf"),
                  "continents": LAND_FIELDS, "continents_sst": SST_FIELDS,
                  "giant": GIANT_FIELDS, "shallow": ("ucomp", "vcomp", "vor", "div", "h")}
# sw_flux launches per step on each rank (every step is a radiation step)
SHARDED_SW_FLUX_PER_STEP = {"mima": 1, "socrates_cloud": 1}
# the models whose tile restart each rank writes and reads back
SHARDED_TILES = ("held_suarez", "mima")


def _sharded_model(name, mesh):
    """The single-card phase's model of `name` at float32 on the mesh."""
    from isca_tpu_torch.models.dry import HeldSuarezModel
    from isca_tpu_torch.models.giant import giant_planet_model
    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.models.shallow import ShallowModel

    f32 = torch.float32
    if name == "giant":
        return giant_planet_model(dtype=f32, mesh=mesh, **GIANT_BIG)
    if name == "shallow":
        return ShallowModel(simple_config("shallow", f32), mesh=mesh)
    if name in ("continents", "continents_sst"):
        return continents_model(f32, continents_sst=name == "continents_sst", mesh=mesh)
    cfg = {"held_suarez": lambda: hs_config(f32), "frierson": lambda: frierson_config(f32),
           "mima": lambda: mima_config(f32),
           "socrates_cloud": lambda: cloud_phase_config("socrates_cloud", f32,
                                                        moist_start=True)}[name]()
    cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, mesh=mesh))
    return HeldSuarezModel(cfg) if name == "held_suarez" else GreyMoistModel(cfg)


def _sharded_compare_run(model, fields, mesh, nlat):
    """HS_COMPARE_STEPS steps from cold start, the last with the physics
    diagnostics where the model has them (as each single-card phase runs
    them): the named fields gathered from the ranks, as float64 numpy."""
    from isca_tpu_torch.parallel.mesh import gather_pytree

    state = model.initial_state()
    if hasattr(model, "step_with_diagnostics"):
        state = model.run(state, HS_COMPARE_STEPS - 1)
        state, diag = model.step_with_diagnostics(state)
        diag = dict(diag, bucket_depth=state.bucket_depth.curr)
    else:
        state = model.run(state, HS_COMPARE_STEPS)
        diag = model.diag_fields(state)
    got = gather_pytree(mesh, {k: diag[k] for k in fields}, nlat=nlat)
    return {k: v.cpu().numpy().astype(np.float64) for k, v in got.items()}, state


def _spectral_block(state):
    """The rank's block of the spectral temperature (vorticity for shallow
    water)."""
    return state.vors.curr if hasattr(state, "vors") else (
        state.ts.curr if hasattr(state, "ts") else state.dyn.ts.curr)


def _sharded_tiles(name, model, state, mesh, nlat, outdir, rep):
    """The state's tile restart: written by every rank, read back into its
    blocks, and combined into one file on rank 0; all bit-equal."""
    import torch.distributed as dist
    from isca_tpu_torch.io import distributed as dio
    from isca_tpu_torch.io.restart import load_restart
    from isca_tpu_torch.parallel.mesh import gather_pytree
    from isca_tpu_torch.utils.tree import flatten_with_paths

    tiles = os.path.join(outdir, f"{name}_tiles")
    dio.save_restart_sharded(tiles, state, mesh, nlat=nlat)
    dist.barrier()
    loaded = dio.load_restart_sharded(tiles, model.initial_state(), mesh)
    rep["tile_blocks_bit_equal"] = all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for (_, a), (_, b) in zip(flatten_with_paths(state), flatten_with_paths(loaded)))
    whole = gather_pytree(mesh, state, nlat=nlat)
    if mesh.rank == 0:
        combined = os.path.join(outdir, f"{name}_combined.npz")
        dio.combine_restart_tiles(tiles, combined)
        back = load_restart(combined, whole)
        rep["combined_bit_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(flatten_with_paths(whole), flatten_with_paths(back)))
        rep["tile_mb"] = sum(os.path.getsize(os.path.join(tiles, f))
                             for f in os.listdir(tiles)) / 2**20


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
    gathered fields (rank 0 writes them), its blocks, the tile restarts,
    the timed runs, its sw_flux launches; the rank's report in
    outdir/rank<r>.json."""
    import warnings

    import torch.distributed as dist
    from isca_tpu_torch.parallel.mesh import make_mesh
    from isca_tpu_torch.physics import rrtmg_sw

    warnings.simplefilter("ignore", RuntimeWarning)   # the synthetic LW k-tables say so
    mesh = make_mesh(SHARDED_RANKS)
    report = {"rank": rank, "device": str(mesh.device), "backend": mesh.backend}
    for name, fields in SHARDED_MODELS.items():
        t0 = time.perf_counter()
        model = _sharded_model(name, mesh)
        T = model.core.T if hasattr(model, "core") else model.T
        torch.cuda.synchronize()
        rrtmg_sw.sw_flux_solve.launches = 0
        got, state = _sharded_compare_run(model, fields, mesh, T.nlat)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{name}.npz"), **got)
        blocks = mesh.all_gather(_spectral_block(state)[None], 0)
        rep = {"m_rows": [T.m_start, T.m_start + T.spec_shape[0]],
               "lat_rows": [T.lat_start, T.lat_start + T.grid_shape[0]],
               "m_blocks_distinct": not torch.equal(blocks[0], blocks[1])}
        dist.barrier()
        state, rep["ms_per_step"] = _sharded_steps(model, state, SHARDED_TIMED_STEPS)
        dist.barrier()
        with _timed_collectives() as acc:
            state, rep["instrumented_ms_per_step"] = _sharded_steps(
                model, state, SHARDED_TIMED_STEPS)
        torch.cuda.synchronize()
        rep["sw_flux_launches"] = rrtmg_sw.sw_flux_solve.launches
        rep["steps"] = HS_COMPARE_STEPS + 2 * SHARDED_TIMED_STEPS
        for n, (calls, seconds) in acc.items():
            rep[n] = {"calls_per_step": calls / SHARDED_TIMED_STEPS,
                      "ms_per_step": 1e3 * seconds / SHARDED_TIMED_STEPS,
                      "share_of_instrumented_step":
                          1e3 * seconds / SHARDED_TIMED_STEPS / rep["instrumented_ms_per_step"]}
        if name in SHARDED_TILES:
            _sharded_tiles(name, model, state, mesh, T.nlat, outdir, rep)
        rep["seconds"] = time.perf_counter() - t0
        report[name] = rep
        del model, state
        torch.cuda.empty_cache()
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
               "timed_steps": SHARDED_TIMED_STEPS}
        failures = []
        for name, fields in SHARDED_MODELS.items():
            with np.load(os.path.join(tmp, f"{name}.npz")) as data:
                got = {k: data[k] for k in fields}
            card, cpu32, cpu64 = COMPARE_REFS[name]
            compare, ok = gap_compare(got, cpu32, cpu64, HS_TOL_FACTOR, fields)
            rows = [r[name]["m_rows"] for r in ranks]
            launches = [r[name]["sw_flux_launches"] for r in ranks]
            want = SHARDED_SW_FLUX_PER_STEP.get(name, 0) * ranks[0][name]["steps"]
            model = {"compare_steps": HS_COMPARE_STEPS, "tolerance_factor": HS_TOL_FACTOR,
                     "compare": compare,
                     "sharded_vs_one_card": {k: float(np.abs(got[k] - card[k]).max())
                                             for k in fields},
                     "m_rows": rows, "lat_rows": [r[name]["lat_rows"] for r in ranks],
                     "sw_flux_launches_per_rank": launches, "sw_flux_expected_per_rank": want,
                     "ranks": [{k: v for k, v in r[name].items()
                                if k not in ("m_rows", "lat_rows")} for r in ranks]}
            if not ok:
                failures.append(f"{name}: the sharded fields break the 3x rule: {compare}")
            if len({tuple(x) for x in rows}) != SHARDED_RANKS or not all(
                    r[name]["m_blocks_distinct"] for r in ranks):
                failures.append(f"{name}: the ranks' m blocks are not distinct: {rows}")
            if any(n != want for n in launches):
                failures.append(f"{name}: sw_flux launched {launches} times on the ranks, "
                                f"expected {want} on each")
            if name in SHARDED_TILES:
                tiles = [r[name] for r in ranks]
                if not (all(t["tile_blocks_bit_equal"] for t in tiles)
                        and tiles[0]["combined_bit_equal"]):
                    failures.append(f"{name}: the tile restart did not load back bit-equal")
            out[name] = model
    out["phase_seconds"] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("sharded: " + "; ".join(failures))
    return out


def phase_giant_t213_compare(cpu_refs):
    """The `giant` phase's 3 T213L30 card steps against the CPU's float32
    and float64 runs by the 3x rule; keeps all three for `sharded`."""
    t0 = time.perf_counter()
    cpu = cpu_refs["giant_t213"].result()
    wait_s = time.perf_counter() - t0
    card = COMPARE_REFS["giant"]
    compare, ok = gap_compare(card, cpu["float32"][0], cpu["float64"][0], FR_TOL_FACTOR,
                              GIANT_FIELDS)
    emit({"phase": "giant_t213_compare", "model": "giant_planet_model", "resolution": "T213",
          "levels": GIANT_BIG["num_levels"], "dtype": "torch.float32",
          "compare_steps": FR_COMPARE_STEPS, "tolerance_factor": FR_TOL_FACTOR,
          "compare": compare, "cpu_reference_wait_s": wait_s})
    if not ok:
        raise RuntimeError(f"giant_t213_compare: card and CPU runs disagree after "
                           f"{FR_COMPARE_STEPS} steps at T213L30: {compare}")
    COMPARE_REFS["giant"] = (card, cpu["float32"][0], cpu["float64"][0])


# ---------------------------------------------------------------------------
# precision: transform_precision "high" (3xTF32) and "default" (one TF32
# pass), and the port's climate gate
# ---------------------------------------------------------------------------

PRECISION_MODES = ("high", "default")
PRECISION_SHAPES = (("T85", 25), ("T213", 30))   # HS T85L25, the giant's T213L30
PRECISION_FIELDS = 3              # fields per product (the dycore batches 2 to 6)
# card against the plain version of the same mode: the operands are rounded
# alike, so the two differ by their FP32 sums over K' terms (K' = the parts
# times the contracted length; cuBLAS's order, and the tensor cores' sums
# round toward zero, -3.75 u |x||table| on average for positive operands,
# measured on an H100), and the tensor cores flush subnormal operands (the
# Legendre tables hold some near the poles): at most PRECISION_ULPS x
# (sqrt(K') u |x| |table| + K' tiny max|x|) per entry
PRECISION_ULPS = 8.0
FP32_U = 2.0 ** -24
FP32_TINY = 2.0 ** -126   # the smallest normal float32
# "high" against "highest" after 3 card steps: the 3x rule scaled by
# 2^(24-22), because the two TF32 parts leave 2^-22 of each operand where
# FP32 rounding leaves 2^-24 (tests/test_torch_precision.py measured 4.3x
# the gap at T21 on the CPU): 12x the CPU's float32-versus-float64 gap that
# the `mima` and `giant_t213_compare` phases measured
HIGH_VS_HIGHEST_FACTOR = 3.0 * 2.0 ** (24 - 22)
PRECISION_HS_TIMED_STEPS = 144    # one model day per mode
PRECISION_GATE_DAYS = 3           # the gate's fewest steps: 256 spin-up, 256 averaged


def _tf32_off(where):
    """The cuBLAS TF32 switch is off again (isca_tpu_torch sets it off; the
    precision module turns it on only around its own products)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"precision: the TF32 switch was left on after {where}")


def _product_inputs(T, L, seed):
    """Seeded float32 inputs of T's four products for L levels, shaped as
    the main path gives them: {name: (x, axis, table name, kind, K)}."""
    rng = np.random.default_rng(seed)
    M1, N1 = T.num_fourier + 1, T.num_spherical + 1
    lead = (PRECISION_FIELDS, L)
    r = lambda *shape: rng.standard_normal(lead + shape).astype(np.float32)
    # a smooth positive field (a temperature), whose FP32 sums all add: the
    # card's TF32 tensor-core sums round toward zero, so this case shows
    # their bias, which random signs hide
    smooth = (250.0 + r(T.nlat, T.nlon)).astype(np.float32)
    return {"dft_analysis": (r(T.nlat, T.nlon), -1, "dft_ana", "dft", T.nlon),
            "dft_analysis_smooth": (smooth, -1, "dft_ana", "dft", T.nlon),
            "legendre_analysis": (r(T.nlat, M1, 2), -3, "Pw", "analysis", T.nlat),
            "legendre_synthesis": (r(M1, N1, 2), -2, "P", "synthesis", N1),
            "dft_synthesis": (r(T.nlat, 2 * M1), -1, "dft_syn", "dft", 2 * M1)}


def _product_errors(x, kind, card, plain, plain_t, mode):
    """(largest |card - plain|, its largest ratio to sqrt(K') u |x||table| +
    K' tiny max|x|, the card's mean signed error against the float64
    product of the same split operands in units of u |x||table|)."""
    from isca_tpu_torch.spectral import precision as prec

    xs = prec.split(x, prec.DATA_AXIS[kind], mode)
    k = xs.shape[prec.DATA_AXIS[kind]]          # K' = the parts times the contracted length
    mag = prec.contract(kind, plain_t.abs(), xs.abs()).double()   # exact FP32: TF32 is off
    err = (card.double() - plain.double()).abs()
    scale = np.sqrt(k) * FP32_U * mag + k * FP32_TINY * float(x.abs().max())
    exact = prec.contract(kind, plain_t.double(), xs.double())
    signed = ((card.double() - exact) / (FP32_U * mag).clamp_min(1e-300)).mean()
    return float(err.max()), float((err / scale).max()), float(signed)


def _check_products(res, L, mode):
    """Each transform product of `res` at `mode` on the card against the
    plain version of the same mode on the CPU, and against the card's
    "highest" product of the same inputs."""
    from isca_tpu_torch.spectral import precision as prec
    from isca_tpu_torch.spectral import transforms as ttr

    Tc = ttr.make_transforms(res, dtype=torch.float32, precision=mode)
    Th = ttr.make_transforms(res, dtype=torch.float32, device="cpu", precision=mode)
    out = {}
    for name, (x, axis, table, kind, K) in _product_inputs(Tc, L, SEED + L).items():
        xc, xh = torch.as_tensor(x, device="cuda"), torch.as_tensor(x)
        card = ttr._product(Tc, xc, kind, getattr(Tc, table), getattr(Tc, table + "_x"))
        _tf32_off(f"{res} {name} at {mode!r}")
        plain = ttr._product(Th, xh, kind, getattr(Th, table), getattr(Th, table + "_x"))
        highest = prec.contract(kind, getattr(Tc, table), xc)
        plain_t = prec.split_table(getattr(Tc, table), prec.TABLE_AXIS[kind], mode)
        err, ratio, signed = _product_errors(xc, kind, card, plain.to("cuda"), plain_t, mode)
        vs_highest = float((card - highest).abs().max() / highest.abs().max())
        out[name] = {"shape": list(x.shape), "K": K, "parts": prec.PARTS[mode],
                     "max_abs_err_vs_plain": err,
                     "err_over_sqrtK_u_mag": ratio, "bound_ulps": PRECISION_ULPS,
                     "mean_signed_err_vs_f64_over_u_mag": signed,
                     "max_rel_diff_vs_highest": vs_highest, "ok": ratio <= PRECISION_ULPS}
        del card, plain, highest, plain_t
    return out


# the kernel's four products: name -> (kind, table attribute of the transforms)
TF32_PRODUCTS = {"dft_analysis": ("dft", "dft_ana"), "legendre_analysis": ("analysis", "Pw"),
                 "legendre_synthesis": ("synthesis", "P"), "dft_synthesis": ("dft", "dft_syn")}
TF32_PRODUCT_REPS = 20
TF32_PLAIN_REPS = 5       # the plain "high" product at T213L30 takes ~2.3 ms


def _tf32_product_shape(T, name):
    """The data operand's shape after the batch, as the main path gives it
    (on a mesh: the rank's band of latitudes, all latitudes of its m block)."""
    band, M1, N1 = T.lats.shape[0], T.spec_shape[0], T.num_spherical + 1
    return {"dft_analysis": (band, T.nlon), "legendre_analysis": (T.nlat, M1, 2),
            "legendre_synthesis": (M1, N1, 2),
            "dft_synthesis": (band, 2 * (T.num_fourier + 1))}[name]


def tf32_product_bound(x, out, t, mode):
    """(bound ms, "bytes" or "operations", bytes, operations) of one product:
    x read once, the output written once, the table's hi (and lo) entries
    outside the skipped triangle read once; 2 operations per term and part
    product (3 part products at "high", 1 at "default") at the tensor
    cores' TF32 rate."""
    from isca_tpu_torch.spectral import precision as prec

    nz = t.nz.cpu().long()
    if t.kind == "analysis":
        entries = t.K * int((t.N - nz).clamp_min(0).sum())
    elif t.kind == "synthesis":
        entries = t.N * int((t.K - nz).clamp_min(0).sum())
    else:
        entries = t.G * t.K * t.N
    rows = out.numel() // (t.G * t.N)
    nbytes = 4 * (x.numel() + out.numel() + prec.TABLE_PARTS[mode] * entries)
    ops = 2 * rows * entries * prec.PARTS[mode]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_TF32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, ops


def check_tf32_product(case, T, name, mode, x, table=None, timed=True):
    """The kernel's product `name` of the transforms T at `mode` on x against
    its plain version on the card (product_reference, exact FP32 products of
    the same split operands) within PRECISION_ULPS, with its mean signed
    error against float64; timed beside the plain version, the exact cuBLAS product the port makes at "highest"
    (library_ms) and, at "default", the TF32 cuBLAS product (device time
    under torch.profiler, device_ms), its time with CUDA events around
    each call (wall_ms, the host's launch included), and its bound.
    `table`: another float32 table of the same layout (the bias cases)."""
    from isca_tpu_torch.spectral import precision as prec

    kind, attr = TF32_PRODUCTS[name]
    raw = getattr(T, attr) if table is None else table
    packed = getattr(T, attr + "_x") if table is None else prec.pack_table(raw, kind, mode)
    plain_t = prec.split_table(raw, prec.TABLE_AXIS[kind], mode)
    kernel = lambda: prec.product(x, kind, packed, mode)
    plain = lambda: prec.product_reference(x, kind, plain_t, mode)
    before = prec.product.launches
    out = kernel()
    torch.cuda.synchronize()
    launched = prec.product.launches - before
    ref = plain()
    _tf32_off(f"tf32_product {case}")
    err, ratio, signed = _product_errors(x, kind, out, ref, plain_t, mode)
    finite = bool(torch.isfinite(out).all())
    args = prec.launch_args(x, kind, packed)
    row = dict(case=case, product=name, kind=kind, mode=mode, shape=list(x.shape),
               contiguous=x.is_contiguous(), K=packed.K, N=packed.N, groups=packed.G,
               rows=args.rows, grid=list(args.plan.grid), load=args.load,
               max_abs_err=err, err_over_sqrtK_u_mag=ratio, bound_ulps=PRECISION_ULPS,
               mean_signed_err_vs_f64_over_u_mag=signed, launches_per_call=launched)
    if timed:
        def tf32_cublas():
            with prec.tf32_products(x.device):
                return prec.contract(kind, raw, x)
        bound_ms, bound_by, nbytes, ops = tf32_product_bound(x, out, packed, mode)
        row.update(ms=device_ms(kernel, TF32_PRODUCT_REPS, launches=1),
                   wall_ms=cuda_time_ms(kernel),
                   plain_ms=device_ms(plain, TF32_PLAIN_REPS),
                   library_ms=device_ms(lambda: prec.contract(kind, raw, x), TF32_PRODUCT_REPS),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, operations=ops)
        if mode == "default":
            row["tf32_library_ms"] = device_ms(tf32_cublas, TF32_PRODUCT_REPS)
        _tf32_off(f"tf32_product {case} timing")
    row["ok"] = ratio <= PRECISION_ULPS and finite and launched == 1
    emit({"phase": "kernels", "kernel": "tf32_product", **row})
    if not row["ok"]:
        raise RuntimeError(f"tf32_product {case}: beyond {PRECISION_ULPS} (ratio {ratio}), "
                           f"non-finite ({not finite}) or {launched} launches")
    return row


def tf32_product_cases():
    """The kernel at the four products of HS T85L25 and the giant's T213L30
    (3 fields of all levels, both modes; the first case is the main
    path's), rank 1 of 2's m block and latitude band at T85L25 (the band a
    non-contiguous slice of the whole grid), the ragged T42L25 (K and n no
    multiples of 8), and at "high" with a positive table and positive x,
    whose sums all add: the cases that show the tensor cores' bias."""
    from isca_tpu_torch.parallel.mesh import Mesh
    from isca_tpu_torch.spectral import transforms as ttr

    rng = np.random.default_rng(SEED)
    normal = lambda shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                           device="cuda")
    cases = []
    for res, L in (("T85", 25), ("T213", 30), ("T42", 25)):
        lead = (PRECISION_FIELDS, L)
        for mode in PRECISION_MODES:
            T = ttr.make_transforms(res, dtype=torch.float32, precision=mode)
            for name in TF32_PRODUCTS:
                cases.append(check_tf32_product(f"{res}L{L}_{name}_{mode}", T, name, mode,
                                                normal(lead + _tf32_product_shape(T, name))))
            del T
    lead = (PRECISION_FIELDS, 25)
    mesh = Mesh(group=None, rank=1, size=2, backend="nccl", device=torch.device("cuda"))
    for mode in PRECISION_MODES:
        T = ttr.make_transforms("T85", dtype=torch.float32, precision=mode, mesh=mesh)
        lat = slice(T.lat_start, T.lat_start + T.lats.shape[0])
        for name in TF32_PRODUCTS:
            x = normal(lead + _tf32_product_shape(T, name))
            if name == "dft_analysis":      # the band cut from the whole grid
                x = normal(lead + (T.nlat, T.nlon))[..., lat, :]
            cases.append(check_tf32_product(f"T85L25_rank1of2_{name}_{mode}", T, name, mode,
                                            x))
    T = ttr.make_transforms("T85", dtype=torch.float32, precision="high")
    for name in TF32_PRODUCTS:
        x = normal(lead + _tf32_product_shape(T, name)).abs() + 0.5
        cases.append(check_tf32_product(f"T85L25_{name}_high_positive", T, name, "high", x,
                                        table=getattr(T, TF32_PRODUCTS[name][1]).abs(),
                                        timed=False))
    T = ttr.make_transforms("T213", dtype=torch.float32, precision="high")
    x = normal((PRECISION_FIELDS, 30) + _tf32_product_shape(T, "dft_analysis")).abs() + 0.5
    cases.append(check_tf32_product("T213L30_dft_analysis_high_positive", T, "dft_analysis",
                                    "high", x, table=T.dft_ana.abs(), timed=False))
    return cases


def _hs_steps(mode, device):
    from isca_tpu_torch.models.dry import HeldSuarezModel

    model = HeldSuarezModel(hs_config(torch.float32, mode), device=device)
    state = model.run(model.initial_state(), HS_COMPARE_STEPS)
    return model, state, hs_fields(model, state)


def _bit_equal(a, b):
    """The fields of b that a does not equal to the bit."""
    return sorted(k for k in b if not np.array_equal(a[k], b[k]))


def _vs_highest(gpu, highest, cpu32, cpu64, fields):
    """Each field's card difference from the card's "highest" run against
    HIGH_VS_HIGHEST_FACTOR times the CPU's float32-versus-float64 gap."""
    compare = {}
    for k in fields:
        gap = float(np.abs(cpu32[k] - cpu64[k]).max())
        compare[k] = {"max_abs_diff_vs_highest": float(np.abs(gpu[k] - highest[k]).max()),
                      "tolerance": HIGH_VS_HIGHEST_FACTOR * gap, "cpu_f32_vs_f64": gap}
    return compare, all(c["max_abs_diff_vs_highest"] <= c["tolerance"]
                        for c in compare.values())


def phase_precision():
    """transform_precision "high" and "default" on the card: the transform
    products at T85L25 and T213L30 against their plain version, HS T85L25 at
    each mode against the CPU, the giant T213L30 and MiMA T42L25 at "high"
    against the card's "highest", ms per step by mode, the TF32 switch after
    every call, the "highest" runs equal to the earlier phases' to the bit,
    and the port's Held-Suarez gate at T42 with its fewest steps. Returns the
    tf32_product launches by path: the HS "high" run (the main path), the
    giant's and MiMA's "high" runs."""
    from isca_tpu_torch import climate_gate
    from isca_tpu_torch.models.giant import giant_planet_model
    from isca_tpu_torch.models.moist import GreyMoistModel
    from isca_tpu_torch.physics import rrtmg_sw
    from isca_tpu_torch.spectral import precision as prec

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _tf32_off("the earlier phases")
    products = {f"{res}L{L}": {mode: _check_products(res, L, mode) for mode in PRECISION_MODES}
                for res, L in PRECISION_SHAPES}
    bad = [(r, m, n) for r, d in products.items() for m, rows in d.items()
           for n, row in rows.items() if not row["ok"]]
    emit({"phase": "precision", "part": "products", "dtype": "torch.float32",
          "bound": f"|card - plain| <= {PRECISION_ULPS} (sqrt(K') u |x||table| + K' tiny "
                   "max|x|), u = 2^-24, tiny = 2^-126",
          "products": products})
    if bad:
        raise RuntimeError(f"precision: products beyond their bound: {bad}")

    # Held-Suarez T85L25, 3 steps at each mode against the CPU's run of that
    # mode by the 3x rule; "highest" again, equal to the dycore phase's
    card_ref, _, cpu64 = COMPARE_REFS["held_suarez"]
    hs, ms_hs, hs_stages = {}, {}, {}
    launches = {}
    for mode in ("highest",) + PRECISION_MODES:
        torch.cuda.synchronize()
        prec.product.launches = 0
        model, state, gpu = _hs_steps(mode, None)
        torch.cuda.synchronize()
        launches[f"precision_hs_T85L25_{mode}"] = prec.product.launches
        if (prec.product.launches == 0) != (mode == "highest"):
            raise RuntimeError(f"precision: HS at {mode!r} launched tf32_product "
                               f"{prec.product.launches} times in {HS_COMPARE_STEPS} steps")
        _tf32_off(f"HS steps at {mode!r}")
        if mode == "highest":
            differ = _bit_equal(gpu, card_ref)
            if differ:
                raise RuntimeError(f"precision: HS 'highest' differs from the dycore "
                                   f"phase's run in {differ}")
            hs[mode] = {"bit_equal_to_dycore_phase": True}
        else:
            # The repo's 3x rule at this mode (3x the CPU's own float32-
            # versus-float64 gap at this mode) is reported field by field and
            # not asserted: at "high" the CPU's gap is 0.15-0.64x its exact-
            # FP32 gap, below the 0.97-1.5x of it by which the card's exact run
            # already differs from the CPU's (summation order), so the rule
            # fails there on most fields. What is asserted is 3x the larger
            # of the two gaps (at "default" the mode's own, which is larger).
            # The mode must also change the run: an exact-FP32 "high" would
            # equal the "highest" run to the bit.
            cpu32 = hs_fields(*_hs_steps(mode, "cpu")[:2])
            cpu32_exact = COMPARE_REFS["held_suarez"][1]
            compare = {}
            for k in HS_FIELDS:
                gap_mode = float(np.abs(cpu32[k] - cpu64[k]).max())
                gap_exact = float(np.abs(cpu32_exact[k] - cpu64[k]).max())
                diff = float(np.abs(gpu[k] - cpu32[k]).max())
                compare[k] = {"max_abs_diff": diff,
                              "rule_3x_mode_gap": HS_TOL_FACTOR * gap_mode,
                              "rule_3x_mode_gap_holds": diff <= HS_TOL_FACTOR * gap_mode,
                              "asserted_tolerance": HS_TOL_FACTOR * max(gap_mode, gap_exact),
                              "cpu_mode_f32_vs_f64": gap_mode,
                              "cpu_exact_f32_vs_f64": gap_exact,
                              "card_vs_cpu_f64": float(np.abs(gpu[k] - cpu64[k]).max())}
            ok = all(c["max_abs_diff"] <= c["asserted_tolerance"] for c in compare.values())
            same = _bit_equal(gpu, card_ref) == []
            hs[mode] = {"compare": compare, "ok": ok and not same,
                        "rule_3x_mode_gap_fails": sorted(
                            k for k, c in compare.items() if not c["rule_3x_mode_gap_holds"]),
                        "bit_equal_to_highest": same,
                        "max_rel_diff_vs_highest": {
                            k: float(np.abs(gpu[k] - card_ref[k]).max() / np.abs(card_ref[k]).max())
                            for k in HS_FIELDS}}
            if same:
                raise RuntimeError(f"precision: HS at {mode!r} equals the 'highest' run to "
                                   "the bit: the mode did not reach the products")
            if not ok:
                raise RuntimeError(f"precision: HS at {mode!r} disagrees with the CPU's "
                                   f"run of that mode beyond the asserted bound: {compare}")
        state, _, runs = _timed_runs(model, state, 10, PRECISION_HS_TIMED_STEPS, 1)
        ms_hs[mode] = runs[0]
        prec.product.launches = 0
        kernels, _, stage_rows, _ = profile_stages(model, state, ("dft", "legendre"))
        hs_stages[mode] = {
            "launches_per_step": sum(e.count for e in kernels) / 2,
            "tf32_product_launches_per_step": prec.product.launches / 2,
            **{k: {f: v[f] for f in ("device_ms_per_step", "launches_per_step")}
               for k, v in stage_rows.items()}}
        _tf32_off(f"HS timed run at {mode!r}")
        del model, state
    first = launches["precision_hs_T85L25_high"]
    emit({"phase": "precision", "part": "held_suarez", "resolution": "T85", "levels": 25,
          "compare_steps": HS_COMPARE_STEPS, "tolerance_factor": HS_TOL_FACTOR,
          "modes": hs, "ms_per_step": ms_hs, "timed_steps": PRECISION_HS_TIMED_STEPS,
          "tf32_product_launches_high": first,
          "tf32_product_launches_per_step_high": first / HS_COMPARE_STEPS,
          "profiled_steps": hs_stages,
          "rule_3x_mode_gap_fails_high": len(hs["high"]["rule_3x_mode_gap_fails"]),
          "tf32_split_launches_high": 0,
          "note": "no tf32_split kernel: tf32_product splits x as it loads it"})

    # the giant T213L30: "high" held to the card's "highest", ms per step and
    # the dft and legendre ranges by mode
    giant_ref, g32, g64 = COMPARE_REFS["giant"]
    giant, ms_giant, stages = {}, {}, {}
    for mode in ("highest",) + PRECISION_MODES:
        model = giant_planet_model(dtype=torch.float32, transform_precision=mode, **GIANT_BIG)
        torch.cuda.synchronize()
        prec.product.launches = 0
        gpu, _, state = _diag_compare_run(model, model.initial_state(), GIANT_FIELDS)
        torch.cuda.synchronize()
        if mode == "high":
            launches["precision_giant_T213L30_high"] = prec.product.launches
        _tf32_off(f"giant steps at {mode!r}")
        if mode == "highest":
            differ = _bit_equal(gpu, giant_ref)
            if differ:
                raise RuntimeError(f"precision: giant 'highest' differs from the giant "
                                   f"phase's run in {differ}")
            giant[mode] = {"bit_equal_to_giant_phase": True}
        else:
            compare, ok = _vs_highest(gpu, giant_ref, g32, g64, GIANT_FIELDS)
            giant[mode] = {"vs_highest": compare, "held": mode == "high", "ok": ok}
            if mode == "high" and not ok:
                raise RuntimeError(f"precision: giant at 'high' differs from 'highest' "
                                   f"beyond {HIGH_VS_HIGHEST_FACTOR}x the gap: {compare}")
        # the `giant` phase's timing: one warm-up step, the median of three runs
        state, _, runs = _timed_runs(model, state, GIANT_WARMUP_STEPS - GIANT_COMPARE_STEPS,
                                     GIANT_TIMED_STEPS, GIANT_TIMED_RUNS)
        ms_giant[mode] = statistics.median(runs)
        _, _, stage_rows, _ = profile_stages(model, state, ("dft", "legendre"))
        _tf32_off(f"giant timed run at {mode!r}")
        stages[mode] = {k: {f: v[f] for f in ("device_ms_per_step", "launches_per_step")}
                        for k, v in stage_rows.items()}
        del model, state
        torch.cuda.empty_cache()
    emit({"phase": "precision", "part": "giant", "resolution": "T213", "levels": 30,
          "compare_steps": FR_COMPARE_STEPS, "factor": HIGH_VS_HIGHEST_FACTOR,
          "modes": giant, "ms_per_step": ms_giant, "timed_runs": GIANT_TIMED_RUNS,
          "steps_per_run": GIANT_TIMED_STEPS,
          "stages_device_ms": stages})

    # MiMA T42L25 (sw_flux on its radiation steps) at "high" against "highest"
    mima_ref, m32, m64 = COMPARE_REFS["mima"]
    mima = {}
    for mode in ("highest", "high"):
        torch.cuda.synchronize()
        rrtmg_sw.sw_flux_solve.launches = 0
        prec.product.launches = 0
        gpu = _mima_compare_run(GreyMoistModel(mima_config(torch.float32, precision=mode)))[0]
        torch.cuda.synchronize()
        sw = rrtmg_sw.sw_flux_solve.launches
        _tf32_off(f"MiMA steps at {mode!r}")
        if sw != FR_COMPARE_STEPS:
            raise RuntimeError(f"precision: MiMA at {mode!r} launched sw_flux {sw} "
                               f"times in {FR_COMPARE_STEPS} steps")
        if mode == "highest":
            differ = _bit_equal(gpu, mima_ref)
            if differ:
                raise RuntimeError(f"precision: MiMA 'highest' differs from the mima "
                                   f"phase's run in {differ}")
            mima[mode] = {"bit_equal_to_mima_phase": True, "sw_flux_launches": sw}
            continue
        launches["precision_mima_T42L25_high"] = prec.product.launches
        compare, ok = _vs_highest(gpu, mima_ref, m32, m64, MIMA_FIELDS)
        mima[mode] = {"vs_highest": compare, "ok": ok, "sw_flux_launches": sw,
                      "tf32_product_launches": prec.product.launches}
        if not ok:
            raise RuntimeError(f"precision: MiMA at 'high' differs from 'highest' beyond "
                               f"{HIGH_VS_HIGHEST_FACTOR}x the gap: {compare}")
    emit({"phase": "precision", "part": "mima", "resolution": "T42", "levels": 25,
          "compare_steps": FR_COMPARE_STEPS, "factor": HIGH_VS_HIGHEST_FACTOR,
          "modes": mima})

    # the port's Held-Suarez gate at T42, "high", its fewest steps: the
    # criteria are printed, not asserted (nothing spins up in 512 steps)
    results = {}
    t0 = time.perf_counter()
    climate_gate.gate_held_suarez(PRECISION_GATE_DAYS, results, resolution="T42",
                                  precision="high")
    _tf32_off("the Held-Suarez gate")
    emit({"phase": "precision", "part": "climate_gate", "gate": "held_suarez",
          "resolution": "T42", "precision": "high", "days_arg": PRECISION_GATE_DAYS,
          "steps": 2 * climate_gate.CH, "seconds": time.perf_counter() - t0,
          "criteria": {k: {"value": v.get("value"), "pass": v["pass"]}
                       for k, v in results.items()},
          "note": "criteria printed, not asserted: 512 steps spin nothing up",
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def phase_sharded(smi):
    """The sharded phase: gloo on this card; NCCL when there are two cards.
    Returns each model's sw_flux launches per rank."""
    torch.cuda.empty_cache()
    gloo = _sharded_run("gloo")
    emit({"phase": "sharded", "what": "correctness run of ranks sharing one card over "
          "gloo (staged through the host): not a scaling number", "nvidia_smi": smi,
          **gloo})
    if torch.cuda.device_count() >= 2:
        emit({"phase": "sharded", "what": "ranks on their own cards over NCCL",
              "nvidia_smi": smi, **_sharded_run("nccl")})
    else:
        emit({"phase": "sharded", "backend": "nccl",
              "not_run": f"torch.cuda.device_count() is {torch.cuda.device_count()}: "
                         "NCCL needs one card per rank"})
    return {name: gloo[name]["sw_flux_launches_per_rank"] for name in SHARDED_MODELS}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from isca_tpu_torch import _build      # the package sets TF32 off on import

    t_start = time.perf_counter()
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
        cpu_refs = {name: pool.submit(cpu_reference, name, threads)
                    for name, threads in CLOUD_CPU_REFS.items()}
        cpu_refs.update({name: pool.submit(cpu_reference, name)
                         for name in NEW_PATHS + LATE_CPU_REFS})
        return _run_phases(kind, smi, cpu_refs, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


PHASE_SECONDS = {}


def timed_phase(name, fn, *args):
    """fn(*args), its wall seconds kept in PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def _run_phases(kind, smi, cpu_refs, t_start):
    """Every phase after the build, in order; the phase seconds, the kernels
    summary, the nvidia-smi line and the last line."""
    PHASE_SECONDS["device_and_build"] = time.perf_counter() - t_start
    cases, product_cases = timed_phase("kernels", phase_kernels)
    launches, model, state, ms_per_step = timed_phase("slice", phase_slice)
    timed_phase("profile", phase_profile, model, state, ms_per_step)
    hs_model, hs_state, hs_ms = timed_phase("dycore", phase_dycore)
    timed_phase("dycore_profile", phase_dycore_profile, hs_model, hs_state, hs_ms)
    fr_model, fr_state, fr_ms = timed_phase("moist", phase_moist)
    timed_phase("moist_profile", phase_moist_profile, fr_model, fr_state, fr_ms)
    rrtm_launches = timed_phase("moist_rrtm", phase_moist_rrtm)
    mima_launches = {"mima": timed_phase("mima", phase_mima),
                     "mima_dt_rad": timed_phase("mima_dt_rad", phase_mima_dt_rad)}
    cloud_launches = {name: timed_phase(name, phase_cloud_gcm, name, cpu_refs)
                      for name in CLOUD_PHASES}
    new_paths = {**timed_phase("simple", phase_simple), **timed_phase("giant", phase_giant),
                 **timed_phase("moist_land", phase_moist_land)}
    new_paths.update(mima_gwd=timed_phase("mima_gwd", phase_mima_gwd, cpu_refs),
                     continents_sst=timed_phase("continents_sst", phase_continents_sst,
                                                cpu_refs),
                     ras_bl=timed_phase("ras_bl", phase_ras_bl, cpu_refs))
    exp_launches = timed_phase("experiment", phase_experiment, hs_model, hs_ms, fr_model,
                               fr_ms)
    del hs_model, hs_state, fr_model, fr_state, model, state
    namelist_launches = timed_phase("namelist", phase_namelist, cpu_refs)
    timed_phase("giant_t213_compare", phase_giant_t213_compare, cpu_refs)
    product_launches = timed_phase("precision", phase_precision)
    sharded_launches = timed_phase("sharded", phase_sharded, smi)
    emit({"phase": "summary", "phase_seconds": PHASE_SECONDS,
          "cpu_reference_seconds": {k: f.result()["seconds"] for k, f in cpu_refs.items()},
          "script_seconds_before_summary": time.perf_counter() - t_start})
    main_case = cases[0]                      # the main path's shape and variant
    emit({"kernels": [{
        "name": "sw_flux", "route": "cuda",
        "source": "isca_tpu_torch/csrc/sw_flux.cu",
        "replaces": "isca_tpu/physics/rrtmg_sw.py:782",
        "launches": launches["sw_flux"],
        "launches_by_path": {"slice": launches["sw_flux"], "moist_rrtm": rrtm_launches,
                             **mima_launches, **cloud_launches,
                             **new_paths, **exp_launches,
                             "namelist_mima": namelist_launches,
                             "sharded_per_rank": sharded_launches},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "ok": all(c["ok"] for c in cases), "cases": cases}, {
        "name": "tf32_product", "route": "cuda",
        "source": "isca_tpu_torch/csrc/tf32_product.cu",
        "replaces": "isca_tpu/spectral/transforms.py:161",
        "launches": product_launches["precision_hs_T85L25_high"],
        "launches_by_path": product_launches,
        "max_abs_err": max(c["max_abs_err"] for c in product_cases),
        "ms": product_cases[0]["ms"], "plain_ms": product_cases[0]["plain_ms"],
        "bound_ms": product_cases[0]["bound_ms"], "bound_by": product_cases[0]["bound_by"],
        "library_ms": product_cases[0]["library_ms"],
        "ok": all(c["ok"] for c in product_cases), "cases": product_cases}]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
