"""Build isca_tpu_torch models from a reference Isca `input.nml` (+ `diag_table`).

Port of tools/from_namelist.py, the port's own copy: the same grammar, the
same group-to-dataclass mapping and alias maps, and the same warning for a
key that maps nowhere, building the port's configurations and models.

The reference's whole configuration surface is a Fortran namelist file plus a
diag_table (src/extra/python/isca/experiment.py:143-168 writes them; the
Fortran reads ~40 `*_nml` groups).  This module ingests those exact files and
constructs the equivalent model + DiagTable:

    from isca_tpu_torch.namelist import parse_namelist, model_from_namelist
    nml = parse_namelist(open("input.nml").read())
    model = model_from_namelist(nml)            # on CUDA; device="cpu" here

No f90nml dependency: the parser below handles the namelist grammar the
reference actually emits (f90nml writer output + hand-written test cases):
groups `&name ... /`, scalars, arrays (comma/newline separated), `n*value`
repeats, logicals (.true./.t./T), d/D float exponents, '!'-comments, and
quoted strings.

Mapping policy: each namelist group maps onto its config dataclass by FIELD
NAME (they were designed to correspond; docs/MIGRATING.md is the
human-readable table).  Renames live in explicit alias maps; keys that map
nowhere produce a warning (never silently dropped) unless they are on the
obsolete-by-design list (fms_nml, mpp/IO groups ... there is no FMS here).

CLI:  python -m isca_tpu_torch.namelist INPUT.NML [DIAG_TABLE] [--device cpu]
      builds the model (on CUDA unless --device says otherwise) and prints
      its configuration tree.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import warnings

# ---------------------------------------------------------------------------
# Namelist parser
# ---------------------------------------------------------------------------

_LOGICAL = {".true.": True, ".t.": True, "t": True, "true": True,
            ".false.": False, ".f.": False, "f": False, "false": False}


def _parse_value(tok: str):
    t = tok.strip()
    if not t:
        return None
    if t[0] in "'\"":
        return t[1:-1]
    tl = t.lower()
    if tl in _LOGICAL:
        return _LOGICAL[tl]
    t2 = tl.replace("d", "e")
    try:
        if re.fullmatch(r"[+-]?\d+", t2):
            return int(t2)
        return float(t2)
    except ValueError:
        return t  # bare string (f90nml writes some unquoted)


def _split_values(rhs: str) -> list:
    """Split a namelist RHS on commas, honoring quotes and n*value repeats."""
    toks, cur, q = [], "", None
    for ch in rhs:
        if q:
            cur += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur += ch
        elif ch == ",":
            toks.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        toks.append(cur)
    out = []
    for tok in toks:
        t = tok.strip()
        if not t:
            continue
        m = re.fullmatch(r"(\d+)\s*\*\s*(\S.*)", t)
        if m and not t[0] in "'\"":
            out.extend([_parse_value(m.group(2))] * int(m.group(1)))
        else:
            out.append(_parse_value(t))
    return out


def _strip_comment(line: str) -> str:
    out, q = "", None
    for ch in line:
        if q:
            out += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            out += ch
        elif ch == "!":
            break
        else:
            out += ch
    return out


def parse_namelist(text: str) -> dict:
    """Parse Fortran namelist text -> {group: {key: value}} (keys lowercase)."""
    groups: dict[str, dict] = {}
    cur: dict | None = None
    pending_key: str | None = None
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        m = re.match(r"&(\w+)\s*$", line)
        if m:
            cur = groups.setdefault(m.group(1).lower(), {})
            pending_key = None
            continue
        if line in ("/", "&end", "&"):
            cur = None
            pending_key = None
            continue
        if cur is None:
            continue
        # may contain one or more `key = values` segments; values may continue
        # across lines (no new `key =`)
        while line:
            m = re.match(r"\s*,?\s*(\w+)\s*(?:\([^)]*\))?\s*=\s*", line)
            if m:
                pending_key = m.group(1).lower()
                line = line[m.end():]
                # find a following `key =` on this line (rare in practice)
                nxt = re.search(r",\s*\w+\s*(?:\([^)]*\))?\s*=", line)
                rhs, line = (line[: nxt.start()], line[nxt.start():]) if nxt else (line, "")
                cur[pending_key] = _split_values(rhs)
            elif pending_key is not None:
                cur[pending_key] = cur[pending_key] + _split_values(line)
                line = ""
            else:
                break
    # unwrap single-element lists
    for g in groups.values():
        for k, v in g.items():
            if isinstance(v, list) and len(v) == 1:
                g[k] = v[0]
    return groups


# ---------------------------------------------------------------------------
# diag_table parser (FMS format: diag_table.F90; rendered by the reference's
# isca/templates/diag_table jinja)
# ---------------------------------------------------------------------------

def parse_diag_table(text: str):
    """FMS diag_table text -> isca_tpu_torch DiagTable.

    Line shapes (after the 2 header lines):
      "file", freq, "units", format, "time_units", "long_name"
      "module", "field", "output_name", "file", "all"|..., .true./.false., "none", 2
    """
    from isca_tpu_torch.io.diag_manager import DiagTable

    unit_s = {"seconds": 1, "minutes": 60, "hours": 3600, "days": 86400,
              "months": 30 * 86400, "years": 360 * 86400}
    dt = DiagTable()
    body = [ln for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]
    for ln in body[2:]:  # skip title + base-date header lines
        parts = _split_values(_strip_comment(ln))
        if len(parts) >= 6 and isinstance(parts[1], (int, float)):
            name, freq, units = parts[0], parts[1], str(parts[2])
            dt.add_file(name, int(freq * unit_s.get(units.lower(), 1)))
        elif len(parts) >= 6:
            module, field, _out, fname, _samp, avg = parts[:6]
            dt.add_field(fname, module, field, time_avg=bool(avg))
    return dt


# ---------------------------------------------------------------------------
# Group -> config-dataclass builders
# ---------------------------------------------------------------------------

# namelist groups with no counterpart in the port by design (no FMS / no MPI /
# no compile step).  Never warned about.
OBSOLETE_GROUPS = {
    "fms_nml", "fms_io_nml", "diag_manager_nml", "mpp_nml", "mpp_io_nml",
    "mpp_domains_nml", "memutils_nml", "xgrid_nml", "topography_nml",
    "gaussian_topog_nml",  # handled via utils.topography at init
}

# per-group keys that are accepted but intentionally dropped (value covered
# elsewhere or vestigial in the reference itself)
DROPPED_KEYS = {
    "main_nml": {"days", "hours", "minutes", "seconds", "current_date",
                 "calendar", "dt_atmos"},          # run length/dt handled below
    "atmosphere_nml": {"idealized_moist_model", "print_interval"},
    "spectral_dynamics_nml": {
        "lon_max", "lat_max", "num_fourier", "num_spherical", "fourier_inc",
        "triang_trunc",                             # -> resolution handling
        "scale_heights", "surf_res", "exponent", "p_press", "p_sigma",
        "initial_sphum",                            # -> moist model config
        "use_virtual_temperature",                  # handled as direct field
    },
    "idealized_moist_phys_nml": {
        "two_stream_gray", "do_rrtm_radiation", "do_socrates_radiation",
        "do_virtual", "do_simple",
    },
    "vert_turb_driver_nml": {"do_mellor_yamada", "do_diffusivity", "do_edt",
                             "do_entrain", "do_stable_bl", "do_shallow_conv",
                             "use_tau", "do_simple", "constant_gust", "gust_scheme"},
    "qe_moist_convection_nml": {"tmax"},            # Tmax fixed at reference value
    "betts_miller_nml": {"do_simp", "do_shallower"},
    "sat_vapor_pres_nml": {"do_simple"},            # -> MoistPhysicsConfig.do_simple_sat
    "diffusivity_nml": {"do_entrain"},
    # legacy FMS derivative form not carried over (surface_flux.F90 old_dtaudv)
    "surface_flux_nml": {"old_dtaudv"},
    # external input files: attach via utils.time_interp / rrtm.o3_field after
    # build (the data files are external inputs in the reference too)
    "rrtm_radiation_nml": {"do_read_ozone", "ozone_file", "co2_file",
                           "do_read_co2"},
    "mixed_layer_nml": {"load_qflux", "time_varying_qflux", "qflux_file_name"},
}


def _build(cls, group: dict, aliases: dict | None = None, gname: str = "",
           extra: dict | None = None):
    """Construct dataclass `cls` from namelist `group` by field-name match."""
    aliases = aliases or {}
    dropped = DROPPED_KEYS.get(gname, set())
    fmap = {f.name.lower(): f for f in dataclasses.fields(cls)}
    kw = dict(extra or {})
    for k, v in group.items():
        kl = aliases.get(k.lower(), k.lower())
        if kl is None or kl in dropped or k.lower() in dropped:
            continue
        f = fmap.get(kl)
        if f is None:
            warnings.warn(f"{gname}.{k}: no matching field on {cls.__name__} "
                          "(value dropped)")
            continue
        if isinstance(v, list) and isinstance(f.default, tuple):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def _resolution_from(sd: dict, default="T42"):
    if "num_fourier" in sd:
        nf = int(sd["num_fourier"])
        name = f"T{nf}"
        from isca_tpu_torch.spectral.transforms import RESOLUTIONS
        if name in RESOLUTIONS:
            return name, None, None
        return nf, sd.get("lon_max"), sd.get("lat_max")
    return default, sd.get("lon_max"), sd.get("lat_max")


def primitive_config_from(nml: dict, **overrides):
    """spectral_dynamics_nml (+main_nml, constants_nml) -> PrimitiveConfig."""
    from isca_tpu_torch.constants import EARTH
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig

    sd = dict(nml.get("spectral_dynamics_nml", {}))
    main = nml.get("main_nml", {})
    resolution, nlon, nlat = _resolution_from(sd)

    vck = tuple((k, float(sd[k])) for k in
                ("scale_heights", "surf_res", "exponent", "p_press", "p_sigma")
                if k in sd)
    extra = {
        "resolution": resolution,
        "dt": float(main.get("dt_atmos", 600)),
        "vert_coord_kwargs": vck,
    }
    if nlon:
        extra["nlon"] = int(nlon)
    if nlat:
        extra["nlat"] = int(nlat)
    if sd.get("triang_trunc") is False:
        extra["truncation_shape"] = "rhomboidal"
    if "fourier_inc" in sd:
        extra["fourier_inc"] = int(sd["fourier_inc"])
    if "constants_nml" in nml:
        extra["constants"] = _build(EARTH.__class__, nml["constants_nml"],
                                    gname="constants_nml")
    extra.update(overrides)
    for k in overrides:   # explicit overrides beat namelist values
        sd.pop(k, None)

    aliases = {
        "robert_coeff": "robert_coeff",
        "use_virtual_temperature": "use_virtual_temperature",
        "do_no_eddy_eddy": None,
    }
    return _build(PrimitiveConfig, sd, aliases, "spectral_dynamics_nml",
                  extra=extra)


_BL_SCHEMES = [("do_mellor_yamada", "mellor_yamada"), ("do_edt", "edt"),
               ("do_entrain", "entrain"), ("do_stable_bl", "stable_bl"),
               ("do_diffusivity", "diffusivity")]


def moist_physics_config_from(nml: dict, **overrides):
    """idealized_moist_phys_nml + sub-groups -> MoistPhysicsConfig."""
    from isca_tpu_torch.physics.astronomy import Orbit
    from isca_tpu_torch.physics.betts_miller import BettsMillerConfig
    from isca_tpu_torch.physics.cloud_simple import CloudSimpleConfig
    from isca_tpu_torch.physics.damping_driver import DampingDriverConfig
    from isca_tpu_torch.physics.diffusivity import DiffusivityConfig
    from isca_tpu_torch.physics.dry_convection import DryConvectionConfig
    from isca_tpu_torch.physics.lscale_cond import LscaleCondConfig
    from isca_tpu_torch.physics.mixed_layer import MixedLayerConfig
    from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig
    from isca_tpu_torch.physics.qe_moist_convection import QEMoistConvectionConfig
    from isca_tpu_torch.physics.ras import RASConfig
    from isca_tpu_torch.physics.surface_flux import SurfaceFluxConfig
    from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig
    from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig

    imp = dict(nml.get("idealized_moist_phys_nml", {}))
    extra: dict = {}

    if imp.get("do_rrtm_radiation"):
        extra["radiation_scheme"] = "rrtm"
    elif imp.get("do_socrates_radiation"):
        extra["radiation_scheme"] = "socrates"
    else:
        extra["radiation_scheme"] = "two_stream"
    if "do_simple" in imp:
        extra["do_simple_sat"] = bool(imp["do_simple"])
    if "sat_vapor_pres_nml" in nml and "do_simple" in nml["sat_vapor_pres_nml"]:
        extra["do_simple_sat"] = bool(nml["sat_vapor_pres_nml"]["do_simple"])

    vt = nml.get("vert_turb_driver_nml", {})
    for key, scheme in _BL_SCHEMES:
        if vt.get(key):
            extra["bl_scheme"] = scheme
            break
    if "constant_gust" in vt:
        extra["gust_const"] = float(vt["constant_gust"])
    if vt.get("do_shallow_conv"):
        extra["do_shallow_conv"] = True

    orbit = None
    if "astronomy_nml" in nml:
        orbit = _build(Orbit, nml["astronomy_nml"],
                       {"obliq": "obliq_deg", "per": "per_deg"}, "astronomy_nml")

    sub = [
        ("qe_moist_convection_nml", QEMoistConvectionConfig, "convection", {}),
        ("betts_miller_nml", BettsMillerConfig, "betts_miller", {}),
        ("dry_convection_nml", DryConvectionConfig, "dry_convection", {}),
        ("ras_nml", RASConfig, "ras", {}),
        ("lscale_cond_nml", LscaleCondConfig, "condensation", {}),
        ("mixed_layer_nml", MixedLayerConfig, "mixed_layer", {}),
        ("surface_flux_nml", SurfaceFluxConfig, "surface", {}),
        ("diffusivity_nml", DiffusivityConfig, "bl", {}),
        ("damping_driver_nml", DampingDriverConfig, "damping", {}),
        ("cloud_simple_nml", CloudSimpleConfig, "cloud", {}),
    ]
    # qflux_nml (analytic Merlis Q-flux) folds into the mixed layer config
    if "qflux_nml" in nml:
        ml = dict(nml.get("mixed_layer_nml", {}))
        ml.update(nml["qflux_nml"])
        nml = dict(nml)
        nml["mixed_layer_nml"] = ml

    for gname, cls, field, al in sub:
        if gname in nml:
            extra[field] = _build(cls, nml[gname], al, gname)
    if "two_stream_gray_rad_nml" in nml:
        ts_extra = {"orbit": orbit} if orbit else {}
        extra["radiation"] = _build(TwoStreamConfig, nml["two_stream_gray_rad_nml"],
                                    {}, "two_stream_gray_rad_nml", extra=ts_extra)
    if "rrtm_radiation_nml" in nml:
        extra["rrtm"] = _build(RRTMConfig, nml["rrtm_radiation_nml"],
                               {"dt_rad": None}, "rrtm_radiation_nml")
        if "dt_rad" in nml["rrtm_radiation_nml"]:
            extra["dt_rad"] = float(nml["rrtm_radiation_nml"]["dt_rad"])
    if "cloud_simple_nml" in nml:
        extra["do_cloud_simple"] = True

    aliases = {"roughness_mom": "roughness_mom"}
    extra.update(overrides)
    return _build(MoistPhysicsConfig, imp, aliases, "idealized_moist_phys_nml",
                  extra=extra)


def model_from_namelist(nml: dict, device=None, **core_overrides):
    """Construct the isca_tpu_torch model equivalent to a reference input.nml.

    Model selection mirrors the reference's codebase/namelist logic
    (atmosphere_nml idealized_moist_model, driver/solo/atmosphere.F90:81-83;
    per-variant path_names for barotropic/shallow/column). device: None
    builds it on CUDA (and raises without it); "cpu" on the CPU.
    """
    if "barotropic_dynamics_nml" in nml:
        from isca_tpu_torch.models.barotropic import BarotropicConfig, BarotropicModel
        g = dict(nml["barotropic_dynamics_nml"])
        g.update(nml.get("stirring_nml", {}))
        cfg = _build(BarotropicConfig, g, {}, "barotropic_dynamics_nml",
                     extra=core_overrides)
        return BarotropicModel(cfg, device=device)
    if "shallow_dynamics_nml" in nml:
        from isca_tpu_torch.models.shallow import ShallowConfig, ShallowModel
        g = dict(nml["shallow_dynamics_nml"])
        g.update(nml.get("shallow_physics_nml", {}))
        cfg = _build(ShallowConfig, g, {}, "shallow_dynamics_nml",
                     extra=core_overrides)
        return ShallowModel(cfg, device=device)

    moist = bool(nml.get("atmosphere_nml", {}).get("idealized_moist_model", False))
    imp = nml.get("idealized_moist_phys_nml", {})
    core = primitive_config_from(
        nml,
        **({"do_water_correction": True,
            "use_virtual_temperature": bool(imp.get("do_virtual", False)),
            "robert_coeff": 0.03} if moist else {}),
        **core_overrides,
    )
    if not moist:
        from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
        from isca_tpu_torch.physics.hs_forcing import HSForcingConfig
        forcing = _build(HSForcingConfig, nml.get("hs_forcing_nml", {}),
                         {}, "hs_forcing_nml")
        return HeldSuarezModel(HeldSuarezConfig(core=core, forcing=forcing), device=device)

    from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel
    phys = moist_physics_config_from(nml)
    extra = {}
    sd = nml.get("spectral_dynamics_nml", {})
    if "initial_sphum" in sd:
        extra["initial_sphum"] = float(sd["initial_sphum"])
    cfg = GreyMoistConfig(core=core, physics=phys, **extra)
    return GreyMoistModel(cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m isca_tpu_torch.namelist",
                                 description="Build the model of a reference "
                                 "input.nml and print its configuration.")
    ap.add_argument("namelist", help="the input.nml")
    ap.add_argument("diag_table", nargs="?", help="an FMS diag_table")
    ap.add_argument("--device", default=None,
                    help="where the model is built (default: CUDA)")
    args = ap.parse_args(argv)
    with open(args.namelist) as fh:
        nml = parse_namelist(fh.read())
    model = model_from_namelist(nml, device=args.device)
    print(f"model: {type(model).__name__}")
    print(model.config)
    if args.diag_table:
        with open(args.diag_table) as fh:
            dt = parse_diag_table(fh.read())
        for fname, spec in dt.files.items():
            print(f"diag file {fname}: every {spec.output_freq_seconds}s, "
                  f"{len(spec.fields)} fields")
    return 0


if __name__ == "__main__":
    sys.exit(main())
