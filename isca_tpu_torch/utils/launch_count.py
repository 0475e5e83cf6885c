"""Count the operations a model step would launch on the card, on the CPU.

    python -m isca_tpu_torch.utils.launch_count MODEL [--resolution T21] [--steps 2]

Runs a model's steps on the CPU under a dispatch mode that counts every
non-view ATen call that reaches a backend: on the card each is about one
kernel launch. The plain PyTorch version of a hand-written kernel counts
as the one launch its kernel makes. The count does not depend on the width,
so a small resolution predicts the full-width one; it does depend on the
number of levels (the column schemes loop over them), which is kept. Prints
one JSON line: the calls per step, and those inside the profiler ranges
of RANGES ("physics", the radiation and cloud schemes, the drags and the
convection and boundary-layer schemes). The models are the test cases'
configurations: frierson, mima (and mima_dt_rad, with MiMA's dt_rad =
7200 s), socrates and socrates_cloud (the SOCRATES aquaplanet without and
with --clouds) and simple_clouds; and the configurations of
isca_tpu_torch/models/cases.py: mima_gwd (MiMA with its damping, the
convective gravity-wave drag and seeded ozone and q-flux series),
continents_sst (realistic continents with prescribed SSTs, sea ice and the
orographic drag), ras (Frierson with RAS) and my25, edt, entrain and
stable_bl (Frierson with that boundary-layer scheme).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from isca_tpu_torch.physics import rrtmg_sw


class CountLaunches(TorchDispatchMode):
    """Counts non-view ATen calls, in all and per profiler range that is open
    while they run."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_range = {}
        self._open = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count(1)
        return func(*args, **(kwargs or {}))

    def count(self, n):
        self.total += n
        for name in set(self._open):
            self.by_range[name] = self.by_range.get(name, 0) + n


def _plain_as_one_launch(counter):
    """sw_flux_solve_reference counted as the kernel's one launch."""
    plain = rrtmg_sw.sw_flux_solve_reference

    def counted(*a, **kw):
        counter.count(1)
        with _disable_current_modes():
            return plain(*a, **kw)
    return plain, counted


def _ranges(counter, names):
    """Open each named torch.profiler range on the counter while it runs."""
    from torch.autograd import profiler

    enter, exit_ = profiler.record_function.__enter__, profiler.record_function.__exit__

    def on_enter(self):
        if self.name in names:
            counter._open.append(self.name)
        return enter(self)

    def on_exit(self, *exc):
        if self.name in names and counter._open:
            counter._open.remove(self.name)
        return exit_(self, *exc)
    return (enter, exit_), (on_enter, on_exit)


MODELS = ("frierson", "mima", "mima_dt_rad", "socrates", "socrates_cloud", "simple_clouds",
          "mima_gwd", "continents_sst", "ras", "my25", "edt", "entrain", "stable_bl")
RANGES = {"physics", "rrtmg_lw", "socrates", "cloud_simple", "cg_drag", "mg_drag", "ras",
          "my25", "edt", "entrain", "stable_bl", "shallow_conv"}


def build(name, resolution):
    from isca_tpu_torch.models import cases, moist

    if name == "mima_gwd":
        return cases.add_mima_series(moist.GreyMoistModel(
            cases.mima_gwd_config(resolution=resolution), device="cpu"))
    if name == "continents_sst":
        return cases.set_continents(moist.GreyMoistModel(
            cases.continents_config(continents_sst=True, resolution=resolution), device="cpu"))
    if name in ("ras", "my25", "edt", "entrain", "stable_bl"):
        scheme = {"ras": "RAS", "my25": "mellor_yamada"}.get(name, name)
        return moist.GreyMoistModel(cases.ras_bl_config(scheme=scheme, resolution=resolution),
                                    device="cpu")
    cfg = {"frierson": moist.frierson_test_case_config,
           "socrates": moist.socrates_aquaplanet_test_case_config,
           "socrates_cloud": lambda: moist.socrates_aquaplanet_test_case_config(True),
           "simple_clouds": moist.simple_clouds_test_case_config,
           }.get(name, moist.mima_test_case_config)()
    physics = cfg.physics
    if name == "mima_dt_rad":
        physics = dataclasses.replace(physics, dt_rad=7200.0)   # exp/namelists/mima.nml:87
    return moist.GreyMoistModel(dataclasses.replace(
        cfg, core=dataclasses.replace(cfg.core, resolution=resolution), physics=physics),
        device="cpu")


def count_steps(model, steps):
    """Launch counts of `steps` leapfrog steps after a first one."""
    from torch.autograd import profiler

    state = model.step(model.initial_state(), first=True)
    counter = CountLaunches()
    plain, counted = _plain_as_one_launch(counter)
    (enter, exit_), (on_enter, on_exit) = _ranges(counter, RANGES)
    rrtmg_sw.sw_flux_solve_reference = counted
    profiler.record_function.__enter__, profiler.record_function.__exit__ = on_enter, on_exit
    try:
        with counter:
            model.run(state, steps, first=False)
    finally:
        rrtmg_sw.sw_flux_solve_reference = plain
        profiler.record_function.__enter__, profiler.record_function.__exit__ = enter, exit_
    return {"per_step": counter.total / steps,
            **{f"{k}_per_step": v / steps for k, v in sorted(counter.by_range.items())}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model", choices=MODELS)
    p.add_argument("--resolution", default="T21")
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    model = build(args.model, args.resolution)
    out = {"model": args.model, "resolution": args.resolution,
           "levels": model.config.core.num_levels, "steps": args.steps,
           "device": "cpu", **count_steps(model, args.steps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
