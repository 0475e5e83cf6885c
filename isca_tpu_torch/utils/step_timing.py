"""Times model steps of the port on the card at one transform precision, so
that two trees of the port can be compared in one call on one card.

    python -m isca_tpu_torch.utils.step_timing --precision high

from a tree's root runs that tree's package (to time an older tree, copy
this file into it and run it there, in turns with this one): Held-Suarez T85L25
(chip_smoke.py's `dycore` configuration, dt = 600 s) for `--hs-runs` runs of
one model day after a warm-up day, and the giant planet T213L30
(chip_smoke.py's `giant` configuration) for `--giant-runs` runs of 10 steps
after 4 warm-up steps, then 2 more giant steps under torch.profiler for the
device ms of its "dft" and "legendre" ranges (2 HS steps are profiled
alike). Prints one JSON line: the package's path, the card's name and power
limit, each run's ms per step, their medians, and per profiled step the
kernel launches, the device ms, the ranges' device ms and the device ms of
the kernels that take most. It reads only what every tree of the port since
transform_precision "high" has: the models and the profiler ranges.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def _runs(model, state, warmup, steps, n):
    """ms per step of n runs of `steps` steps after `warmup` steps."""
    state = model.run(state, warmup, first=True)
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state = model.run(state, steps, first=False)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / steps)
    return state, out


def _profiled(model, state, stages=("dft", "legendre"), steps=2):
    """Over `steps` steps under torch.profiler: kernel launches and device ms
    per step, and the device ms per step of the kernels under each named
    profiler range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.run(state, steps, first=False)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    # a kernel counts in a range when it starts within the range's span on
    # the card (one stream: the kernels launched inside the range on the
    # host), which also finds kernels launched through ctypes, which have
    # no ATen op in the trace
    spans = {s: [] for s in stages}
    for ev in prof.events():
        if (ev.device_type == DeviceType.CUDA and getattr(ev, "is_user_annotation", False)
                and ev.name in spans):
            spans[ev.name].append((ev.time_range.start, ev.time_range.end))
    total = {s: sum(k.time_range.elapsed_us() for k in kernels
                    if any(a <= k.time_range.start <= b for a, b in spans[s]))
             for s in stages}
    by_name = {}
    for k in kernels:
        by_name[k.name[:70]] = by_name.get(k.name[:70], 0.0) + k.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"launches_per_step": len(kernels) / steps,
            "top_kernels_device_ms_per_step": {n: us / 1e3 / steps for n, us in top},
            "device_ms_per_step": sum(k.time_range.elapsed_us() for k in kernels) / 1e3 / steps,
            "stage_device_ms_per_step": {s: v / 1e3 / steps for s, v in total.items()}}


def main(argv=None):
    import isca_tpu_torch
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
    from isca_tpu_torch.models.giant import giant_planet_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="high")
    ap.add_argument("--hs-runs", type=int, default=3)
    ap.add_argument("--giant-runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_timing: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    hs = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(
        resolution="T85", num_levels=25, dt=600.0, dtype=torch.float32,
        transform_precision=args.precision)))
    steps_per_day = int(round(86400.0 / 600.0))
    state, hs_ms = _runs(hs, hs.initial_state(), steps_per_day, steps_per_day, args.hs_runs)
    hs_profile = _profiled(hs, state)
    del hs, state
    giant = giant_planet_model(dtype=torch.float32, transform_precision=args.precision,
                               resolution="T213", num_levels=30, dt=1800.0, cutoff_wn=100)
    state, giant_ms = _runs(giant, giant.initial_state(), 4, 10, args.giant_runs)
    giant_profile = _profiled(giant, state)
    print(json.dumps({
        "package": isca_tpu_torch.__file__, "nvidia_smi": smi,
        "precision": args.precision,
        "held_suarez_T85L25_ms_per_step": hs_ms,
        "held_suarez_T85L25_median": statistics.median(hs_ms),
        "held_suarez_T85L25_profile": hs_profile,
        "giant_T213L30_ms_per_step": giant_ms,
        "giant_T213L30_median": statistics.median(giant_ms),
        "giant_T213L30_profile": giant_profile}), flush=True)


if __name__ == "__main__":
    main()
