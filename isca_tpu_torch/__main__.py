"""Command-line front end: `python -m isca_tpu_torch NAME [options]`.

Port of isca_tpu/__main__.py, which replaces the reference's
`exp/run_isca/isca` CLI (argparse wrapper around Experiment): pick a model
variant, resolution and run length, chain monthly segments with restarts,
and write NetCDF diagnostics per run. It runs on the card unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import sys


MODELS = ("held_suarez", "frierson", "barotropic", "shallow", "giant",
          "column")
# the averaged output fields of the models without temp and ps
FIELDS = {"barotropic": ("ucomp", "vcomp", "vor"),
          "shallow": ("ucomp", "vcomp", "vor", "h")}


def build_model(args):
    import dataclasses

    if args.model == "held_suarez":
        from isca_tpu_torch.dycore.primitive import PrimitiveConfig
        from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
        core = PrimitiveConfig(resolution=args.resolution,
                               num_levels=args.levels, dt=args.dt)
        return HeldSuarezModel(HeldSuarezConfig(core=core), device=args.device)
    if args.model == "frierson":
        from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel
        cfg = GreyMoistConfig()
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(
            cfg.core, resolution=args.resolution, num_levels=args.levels,
            dt=args.dt))
        return GreyMoistModel(cfg, device=args.device)
    if args.model == "giant":
        from isca_tpu_torch.models.giant import giant_planet_model
        return giant_planet_model(resolution=args.resolution,
                                  num_levels=args.levels, dt=args.dt,
                                  device=args.device)
    if args.model == "barotropic":
        from isca_tpu_torch.models.barotropic import BarotropicConfig, BarotropicModel
        return BarotropicModel(BarotropicConfig(resolution=args.resolution, dt=args.dt),
                               device=args.device)
    if args.model == "shallow":
        from isca_tpu_torch.models.shallow import ShallowConfig, ShallowModel
        return ShallowModel(ShallowConfig(resolution=args.resolution, dt=args.dt),
                            device=args.device)
    if args.model == "column":
        from isca_tpu_torch.models.column import ColumnConfig, ColumnModel
        return ColumnModel(ColumnConfig(num_levels=args.levels, dt=args.dt),
                           device=args.device)
    raise SystemExit(f"unknown model {args.model!r}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="isca_tpu_torch",
        description="Run an isca_tpu_torch experiment (exp/run_isca/isca parity)")
    p.add_argument("name", help="experiment name (output directory)")
    p.add_argument("--model", choices=MODELS, default="held_suarez")
    p.add_argument("--resolution", default="T42")
    p.add_argument("--levels", type=int, default=25)
    p.add_argument("--dt", type=float, default=600.0)
    p.add_argument("--days", type=int, default=30,
                   help="days per run segment")
    p.add_argument("-n", "--runs", type=int, default=1,
                   help="number of chained run segments")
    p.add_argument("--start", type=int, default=1,
                   help="first segment index (restart from start-1)")
    p.add_argument("--datadir", default="runs")
    p.add_argument("--daily", action="store_true",
                   help="daily instead of monthly-mean output")
    p.add_argument("--device", default=None,
                   help="torch device, e.g. cpu (default: the CUDA card)")
    args = p.parse_args(argv)

    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io.diag_manager import DiagTable

    model = build_model(args)
    dt_tab = DiagTable()
    freq = 86400 if args.daily else args.days * 86400
    fname = "atmos_daily" if args.daily else "atmos_monthly"
    dt_tab.add_file(fname, freq)
    for field in FIELDS.get(args.model, ("ucomp", "vcomp", "temp", "ps")):
        dt_tab.add_field(fname, "dynamics", field, time_avg=True)

    exp = Experiment(args.name, model, dt_tab, datadir=args.datadir)
    for i in range(args.start, args.start + args.runs):
        print(f"[isca_tpu_torch] {args.name}: run {i} ({args.days} days)")
        exp.run(i, days=args.days)
    print(f"[isca_tpu_torch] done -> {args.datadir}/{args.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
