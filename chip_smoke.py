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
  slice    drives the main path: the RRTM single-column model at T42 width
           (64 x 128 columns, 25 levels, float32, RRTMG-SW + grey LW) through
           ColumnModel.run; compares 3 steps with the same 3 steps on the CPU
           from an 8 x 16-column corner; times 20 more steps; counts the
           kernel launches of that run;
  profile  device time per step by kernel over 2 more steps of the slice
           (torch.profiler), launches per step and the device's idle share.
Then the `{"kernels": [...]}` summary line, the raw `nvidia-smi` name and
power limit line, and last `{"ok": true, "device": {...}}`. Any failed phase
raises, so the script exits non-zero and prints no last line; so does a run
without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
    main_case = cases[0]                      # the main path's shape and variant
    emit({"kernels": [{
        "name": "sw_flux", "route": "cuda",
        "source": "isca_tpu_torch/csrc/sw_flux.cu",
        "replaces": "isca_tpu/physics/rrtmg_sw.py:782",
        "launches": launches["sw_flux"],
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
