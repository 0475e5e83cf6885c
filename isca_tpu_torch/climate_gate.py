"""Climate gate: long-run climatology checks against published results.

Port of tools/climate_gate.py, the repository's long-run check, on
isca_tpu_torch. The spun-up zonal-mean circulation must match the literature
that defines each test case:

* Held & Suarez (1994, BAMS): eddy-driven midlatitude jets of ~30 m/s near
  sigma~0.25 at 40-50 deg, easterlies aloft in the tropics, surface westerlies
  in midlatitudes, T ~ 200 K tropopause.
* Frierson et al. (2006, JAS) grey-radiation aquaplanet: tropical
  precipitation and humidity maximum, jet near 45 deg, warm tropical t_surf.
* Jucker & Gerber (2017) MiMA, Schneider & Liu (2009) giant planet, and the
  realistic continents' seasonal signatures.

    python -m isca_tpu_torch.climate_gate [--days 1200] [--only hs]
        [--precision high] [--json CLIMATE_GATE_TORCH.json] [--device cpu]

Prints one PASS/FAIL line per criterion and writes a JSON artifact
(CLIMATE_GATE_TORCH.json by default: the JAX tool's CLIMATE_GATE.json is
never written). The criteria and their bounds (BOUNDS, bounds_version) are
the JAX tool's, verbatim. The models run on CUDA unless --device names the
CPU.

The state cache that chains a long gate across runs keeps isca_tpu's
npz layout (`leaf{i}` in isca_tpu's pytree order, complex leaves as stacked
(2, ...) real and imaginary parts, `steps`, `avg_steps`, `nleaves`, the JSON
`fingerprint`, `acc_*`), so a chain moves between the two packages in both
directions. The committed caches under exp/gate_cache/ are read-only: a run
that starts from one checkpoints to the same name under .gate_cache/.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.convert import (
    PRIMITIVE_SPECTRAL, PRIMITIVE_TWO_LEVEL, grey_moist_state_from_numpy,
    grey_moist_state_to_numpy, primitive_state_from_numpy, primitive_state_to_numpy)
from isca_tpu_torch.dycore.primitive import PrimitiveState
from isca_tpu_torch.physics.moist_driver import RadCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_CACHES = os.path.join(ROOT, "exp", "gate_cache")
WRITABLE_CACHES = os.path.join(ROOT, ".gate_cache")
DEFAULT_JSON = "CLIMATE_GATE_TORCH.json"
PROTECTED_JSON = ("CLIMATE_GATE.json", "PRECISION_GATE.json")

# Steps per chunk between host synchronisations and checkpoint checks (the
# JAX tool's jit chunk).
CH = 256


def _sync(state_device):
    if state_device.type == "cuda":
        torch.cuda.synchronize(state_device)


def _device_of(state) -> torch.device:
    dyn = state if isinstance(state, PrimitiveState) else state.dyn
    return dyn.ug.curr.device


def _accumulate(model, state, accum_fields, acc, nsteps):
    """nsteps leapfrog steps, adding accum_fields of each new state to the
    float64 accumulators `acc` (dict name -> tensor on the state's device,
    created when None). Returns (state, acc)."""
    for _ in range(nsteps):
        state = model.step(state, first=False)
        fields = accum_fields(state)
        if acc is None:
            acc = {k: torch.zeros(v.shape, dtype=torch.float64, device=v.device)
                   for k, v in fields.items()}
        for k, v in fields.items():
            acc[k].add_(v)
    return state, acc


def zonal_time_mean(model, state, nsteps_spinup, nsteps_avg, accum_fields):
    """Run spinup, then accumulate zonal means of requested diagnostics.

    The spinup runs in CH-step chunks (the first from a cold start when
    nsteps_spinup > 0); with nsteps_spinup == 0 the state is assumed already
    integrated (warm leapfrog levels) and averaging starts at once. The
    averages are summed every step in float64 on the state's device, over
    whole CH-step chunks. Returns (state, {name: float64 numpy mean})."""
    device = _device_of(state)
    t0 = time.time()
    if nsteps_spinup > 0:
        state = model.run(state, CH, first=True)
        for _ in range(max(nsteps_spinup // CH - 1, 0)):
            state = model.run(state, CH, first=False)
            _sync(device)
    print(f"  spinup {nsteps_spinup} steps: {time.time() - t0:.0f}s", flush=True)

    t0 = time.time()
    acc = None
    nchunks = max(nsteps_avg // CH, 1)
    for _ in range(nchunks):
        state, acc = _accumulate(model, state, accum_fields, acc, CH)
        _sync(device)
    nsteps_done = nchunks * CH
    print(f"  averaging {nsteps_done} steps: {time.time() - t0:.0f}s", flush=True)
    return state, {k: v.cpu().numpy() / nsteps_done for k, v in acc.items()}


# ---------------------------------------------------------------------------
# Criterion bounds registry: the JAX tool's (tools/climate_gate.py), verbatim,
# so that bounds_version() stamps the same hash on both packages' records.
#
# [lo, hi] with None for an open side. Compound criteria (checked via
# check(), not bcheck()) store their named sub-thresholds as dicts so the
# version hash still covers them.
BOUNDS = {
    # Held & Suarez 1994 (BAMS)
    "hs_jet_strength": [25.0, 40.0],          # NH jet max, m/s (~30)
    "hs_jet_latitude": [35.0, 55.0],          # deg (40-50)
    "hs_jet_height": [None, 0.45],            # sigma of jet max (~0.25)
    "hs_tropical_easterlies": [None, 5.0],    # upper tropical u, m/s
    "hs_surface_westerlies": [0.0, None],     # midlat sfc u, m/s
    "hs_trade_easterlies": [None, 0.0],       # tropical sfc u, m/s
    "hs_tropopause_temp": [180.0, 215.0],     # tropical T min, K (~200)
    "hs_meridional_contrast": [15.0, 70.0],   # sfc eq-pole dT, K (delh=60)
    # Frierson et al. 2006 (JAS) grey aquaplanet
    "fr_tropical_tsurf": [285.0, 310.0],      # K (~295-305)
    "fr_pole_tsurf": [25.0, None],            # tropics-minus-pole t_surf, K
    "fr_humidity_max_tropics": [None, 15.0],  # |lat| of sfc q max, deg
    "fr_humidity_magnitude": [0.008, 0.03],   # sfc q max, kg/kg (~15-20 g/kg)
    "fr_jet": {"strength": [20.0, 45.0], "latitude": [25.0, 55.0]},
    "fr_surface_winds": {"midlat_u": [0.0, None], "tropical_u": [None, 0.0]},
    # Schneider & Liu 2009 (JAS) giant planet
    "gp_equatorial_superrotation": [10.0, 300.0],   # upper eq u, m/s
    "gp_multiple_jets": [4.0, 1000.0],              # off-eq u sign flips
    "gp_equator_dominates": {"eq_over_max_midlat": [0.5, None]},
    "gp_hemispheric_symmetry": [0.2, 1.0],          # NH/SH jet correlation
    # Jucker & Gerber 2017 (J. Climate) MiMA
    "mima_coldpoint_temp": [180.0, 210.0],          # K (fig. 2: ~190-205)
    "mima_coldpoint_pressure": [50.0, 160.0],       # hPa (obs ~100)
    "mima_stratospheric_inversion": [2.0, 120.0],   # K above cold point
    "mima_jet_strength": [20.0, 50.0],              # m/s
    "mima_jet_latitude": [25.0, 55.0],              # deg
    "mima_tropical_tsurf": [285.0, 310.0],          # K
    "mima_humidity": [8.0, 30.0],                   # sfc q max, g/kg
    # Realistic continents (reference test case; continentality signatures)
    "realistic_land_seasonal_amplitude": [6.0, 80.0],    # K
    "realistic_continentality_ratio": [1.4, 50.0],       # land/ocean amp
    "realistic_winter_jet_stronger": [1.02, 10.0],       # winter/summer jet
    "realistic_tsurf_range_winter": [260.0, 310.0],      # K
    "realistic_tsurf_range_summer": [260.0, 310.0],      # K
    "realistic_olr": [200.0, 290.0],                     # W/m2 (obs ~240)
}


def bounds_version():
    """Short content hash of BOUNDS: stamped into every criterion record so
    an artifact entry generated under superseded bounds is detectable."""
    return hashlib.sha256(
        json.dumps(BOUNDS, sort_keys=True).encode()).hexdigest()[:12]


def check(name, cond, detail, results, value=None, bounds=None):
    """Record one criterion. value/bounds make the artifact auditable:
    every entry carries the measured number and the literature bound."""
    status = "PASS" if cond else "FAIL"
    print(f"[{status}] {name}: {detail}")
    rec = {"pass": bool(cond), "detail": detail,
           "bounds_version": bounds_version()}
    if value is not None:
        rec["value"] = float(value)
    if bounds is None:
        # compound criteria: record the registry's sub-threshold dict
        bounds = BOUNDS.get(name)
    if bounds is not None:
        rec["bounds"] = list(bounds) if not isinstance(bounds, dict) \
            else bounds
    results[name] = rec
    return cond


def bcheck(name, value, detail, results):
    """Bounded criterion: BOUNDS[name][0] <= value <= BOUNDS[name][1]
    (None = open side). Bounds come from the registry ONLY."""
    lo, hi = BOUNDS[name]
    cond = (lo is None or value >= lo) and (hi is None or value <= hi)
    return check(name, cond, detail, results, value=value, bounds=(lo, hi))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _lats_deg(model) -> np.ndarray:
    """Latitudes in degrees in the model's dtype, as isca_tpu's gate takes
    them (np.rad2deg of its float32 table), so both record the same values."""
    return np.rad2deg(_host(model.core.T.lats))


def _zonal(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=-1)


def gate_held_suarez(days, results, resolution="T85", precision="highest",
                     cache=None, deadline=None, device=None):
    """Held & Suarez (1994) at <resolution>L25, dt = 600 s, float32: a third
    of the days spin up, the rest are averaged. With a cache (or a
    deadline) the run is chained through the state cache as the MiMA and
    giant gates are (the same steps and sums: chained equals direct)."""
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel

    core = PrimitiveConfig(resolution=resolution, num_levels=25, dt=600.0,
                           transform_precision=precision,
                           dtype=torch.float32)
    model = HeldSuarezModel(HeldSuarezConfig(core=core), device=device)
    state = model.initial_state()
    spd = int(86400 / core.dt)
    spin = (days // 3) * spd
    avg = (days - days // 3) * spd

    def fields(st):
        return {"u": _zonal(st.ug.curr), "t": _zonal(st.tg.curr)}

    t0 = time.time()
    if cache or deadline:
        fingerprint = {"config": "held_suarez", "resolution": str(resolution),
                       "num_levels": 25, "dt": float(core.dt),
                       "transform_precision": model.core.T.prec}
        state, zm, _ = _chained_spin_and_average(
            model, state, fields, spin, avg, cache=cache,
            fingerprint=fingerprint, deadline=deadline)
    else:
        state, zm = zonal_time_mean(model, state, spin, avg, fields)
    wall = time.time() - t0
    print(f"Held-Suarez {resolution}L25: {days} days in {wall:.0f}s "
          f"({days * 86400 / wall:,.0f} model-days/day)")

    lats = _lats_deg(model)
    # sigma from even levels
    L = zm["u"].shape[0]
    sigma = (np.arange(L) + 0.5) / L

    u, T = zm["u"], zm["t"]
    # jet: max of zonal wind in each hemisphere
    nh = lats > 0
    kjet, jjet = np.unravel_index(np.argmax(u[:, nh]), u[:, nh].shape)
    ujet = u[:, nh].max()
    latjet = lats[nh][jjet]
    sigjet = sigma[kjet]
    bcheck("hs_jet_strength", float(ujet),
           f"NH jet {ujet:.1f} m/s (HS94 ~30)", results)
    bcheck("hs_jet_latitude", float(latjet),
           f"at {latjet:.1f} deg (HS94 40-50)", results)
    bcheck("hs_jet_height", float(sigjet),
           f"at sigma={sigjet:.2f} (HS94 ~0.25)", results)

    # tropical upper-level easterlies
    trop = np.abs(lats) < 10
    utrop_top = u[sigma < 0.3][:, trop].mean()
    bcheck("hs_tropical_easterlies", float(utrop_top),
           f"tropical u(sigma<0.3) mean {utrop_top:.1f} m/s (weak/easterly)",
           results)

    # surface westerlies in midlatitudes, easterlies in tropics (trade winds)
    usfc = u[-1]
    mid = (np.abs(lats) > 35) & (np.abs(lats) < 60)
    bcheck("hs_surface_westerlies", float(usfc[mid].mean()),
           f"midlat sfc u {usfc[mid].mean():.1f} m/s (>0)", results)
    bcheck("hs_trade_easterlies", float(usfc[trop].mean()),
           f"tropical sfc u {usfc[trop].mean():.1f} m/s (<0)", results)

    # temperature: tropopause ~ 200K minimum, no superrotation artifacts
    tmin = T[:, trop].min()
    bcheck("hs_tropopause_temp", float(tmin),
           f"tropical T min {tmin:.0f} K (HS94 ~200)", results)
    # equator-pole surface temperature contrast roughly delh-driven
    dT = T[-1][trop].mean() - T[-1][np.abs(lats) > 75].mean()
    bcheck("hs_meridional_contrast", float(dT),
           f"sfc equator-pole dT {dT:.0f} K (forced by delh=60)", results)


def gate_frierson(days, results, precision="highest", device=None):
    """Frierson et al. (2006): frierson_test_case_config() at T42L25, half
    the days spun up, half averaged."""
    from isca_tpu_torch.models.moist import GreyMoistModel, frierson_test_case_config

    cfg = frierson_test_case_config()
    if precision != cfg.core.transform_precision:
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(
            cfg.core, transform_precision=precision))
    model = GreyMoistModel(cfg, device=device)
    state = model.initial_state()
    spd = int(86400 / model.core.config.dt)
    spin = (days // 2) * spd
    avg = (days - days // 2) * spd

    def fields(st):
        return {"u": _zonal(st.dyn.ug.curr), "ts": _zonal(st.t_surf),
                "q": _zonal(st.dyn.tracers["sphum"].curr)}

    t0 = time.time()
    state, zm = zonal_time_mean(model, state, spin, avg, fields)
    wall = time.time() - t0
    print(f"Frierson T42L25: {days} days in {wall:.0f}s "
          f"({days * 86400 / wall:,.0f} model-days/day)")

    lats = _lats_deg(model)
    u, ts, q = zm["u"], zm["ts"], zm["q"]
    L = u.shape[0]
    sigma = (np.arange(L) + 0.5) / L
    trop = np.abs(lats) < 10

    # warm moist tropics
    bcheck("fr_tropical_tsurf", float(ts[trop].mean()),
           f"tropical t_surf {ts[trop].mean():.1f} K (Frierson ~295-305)",
           results)
    # tropics-minus-pole surface contrast (registry: >= 25 K)
    contrast = float(ts[trop].mean() - ts[np.abs(lats) > 70].mean())
    bcheck("fr_pole_tsurf", contrast,
           f"polar t_surf {ts[np.abs(lats) > 70].mean():.1f} K "
           f"(tropics-pole contrast {contrast:.0f} K)", results)
    # boundary-layer specific humidity maximum at the equator
    qsfc = q[-1]
    qmaxlat = lats[np.argmax(qsfc)]
    bcheck("fr_humidity_max_tropics", float(abs(qmaxlat)),
           f"sfc q max at {qmaxlat:.0f} deg ({qsfc.max() * 1e3:.1f} g/kg)",
           results)
    bcheck("fr_humidity_magnitude", float(qsfc.max()),
           f"sfc q max {qsfc.max() * 1e3:.1f} g/kg (Frierson ~15-20)", results)
    # subtropical/midlatitude jet (compound: thresholds from BOUNDS["fr_jet"])
    nh = lats > 0
    kjet, jjet = np.unravel_index(np.argmax(u[:, nh]), u[:, nh].shape)
    fj = BOUNDS["fr_jet"]
    check("fr_jet", fj["strength"][0] <= u[:, nh].max() <= fj["strength"][1]
          and fj["latitude"][0] <= lats[nh][jjet] <= fj["latitude"][1],
          f"NH jet {u[:, nh].max():.1f} m/s at {lats[nh][jjet]:.0f} deg, "
          f"sigma={sigma[kjet]:.2f}", results)
    # surface wind pattern (compound: BOUNDS["fr_surface_winds"])
    usfc = u[-1]
    mid = (np.abs(lats) > 35) & (np.abs(lats) < 60)
    fw = BOUNDS["fr_surface_winds"]
    check("fr_surface_winds",
          usfc[mid].mean() > fw["midlat_u"][0]
          and usfc[trop].mean() < fw["tropical_u"][1],
          f"sfc u: midlat {usfc[mid].mean():.1f}, tropics "
          f"{usfc[trop].mean():.1f} m/s", results)


def mima_model(resolution=None, device=None):
    """exp/namelists/mima.nml through the port's namelist reader, float32."""
    from isca_tpu_torch.namelist import model_from_namelist, parse_namelist

    with open(os.path.join(ROOT, "exp", "namelists", "mima.nml")) as fh:
        nml = parse_namelist(fh.read())
    overrides = {"resolution": resolution} if resolution else {}
    return model_from_namelist(nml, device=device, dtype=torch.float32, **overrides)


def lw_tables_tag() -> str:
    """The RRTMG-LW k-tables' provenance, as the MiMA cache fingerprint
    records it."""
    kg = np.load(os.path.join(ROOT, "isca_tpu_torch", "data", "rrtmg_lw_kg.npz"))
    if int(np.asarray(kg.get("synthetic", 0))) == 1:
        return f"synthetic_v{int(np.asarray(kg.get('synthetic_version', 3)))}"
    return "aer"


def mima_fingerprint(model):
    """The MiMA gate's cache fingerprint: the model's resolution, levels and
    dt, and the LW tables' provenance."""
    return {"config": "mima", "resolution": str(model.core.config.resolution),
            "num_levels": int(model.core.config.num_levels),
            "dt": float(model.core.config.dt), "lw_tables": lw_tables_tag()}


def gate_mima(days, results, resolution=None, cache=None, deadline=None, device=None):
    """MiMA-style seasonal RRTM aquaplanet (Jucker & Gerber 2017, J. Climate),
    built from exp/namelists/mima.nml with the constant ozone fallback (the
    reference's ozone_1990.nc is not in the repository; isca_tpu's gate falls
    back the same way without it). The slab is cold-started at the
    Jucker-Gerber annual-mean structure (tropics ~300 K, poles ~255 K), and
    mima_tropical_tsurf is flagged IC-dominated below 700 accumulated days
    (see tools/climate_gate.py's gate_mima for the history of this gate)."""
    model = mima_model(resolution, device=device)
    print("  ozone: constant fallback (reference input file not in the repository)")
    state = model.initial_state()
    # cold-start acceleration (fresh starts only: a chained run resumes its
    # own trajectory)
    lat1d = model.core.T.lats
    ts0 = 300.0 - 45.0 * torch.sin(lat1d)[:, None] ** 2
    state = dataclasses.replace(state, t_surf=torch.broadcast_to(
        ts0, model.core.T.grid_shape).to(state.t_surf.dtype).contiguous())
    dt = model.core.config.dt
    spd = int(86400 / dt)
    spin = (days // 2) * spd
    avg = (days - days // 2) * spd
    fingerprint = mima_fingerprint(model)

    # approximate annual-mean pressure ladder for level selection
    ph = _host(model.core.pk) + _host(model.core.bk) * 1.0e5
    p_full = 0.5 * (ph[:-1] + ph[1:])

    def fields(st):
        return {"u": _zonal(st.dyn.ug.curr), "t": _zonal(st.dyn.tg.curr),
                "ts": _zonal(st.t_surf), "q": _zonal(st.dyn.tracers["sphum"].curr)}

    t0 = time.time()
    state, zm, total_steps = _chained_spin_and_average(
        model, state, fields, spin, avg, cache=cache,
        fingerprint=fingerprint, deadline=deadline)
    total_days = total_steps / spd
    wall = time.time() - t0
    print(f"MiMA {model.core.config.resolution}L"
          f"{model.core.config.num_levels}: {total_days:.0f} total days "
          f"(target {days}) in {wall:.0f}s this run")

    lats = _lats_deg(model)
    u, T, ts, q = zm["u"], zm["t"], zm["ts"], zm["q"]
    trop = np.abs(lats) < 15

    # cold-point tropopause in the tropics (Jucker-Gerber fig. 2: ~190-205 K
    # near 100 hPa)
    Ttrop = T[:, trop].mean(axis=1)
    kcp = int(np.argmin(Ttrop))
    bcheck("mima_coldpoint_temp", float(Ttrop[kcp]),
           f"tropical cold point {Ttrop[kcp]:.0f} K at {p_full[kcp]/100:.0f} hPa",
           results)
    bcheck("mima_coldpoint_pressure", float(p_full[kcp] / 100.0),
           f"cold point at {p_full[kcp]/100:.0f} hPa (obs ~100)", results)
    # stratosphere: temperature increases above the cold point (ozone heating)
    strat_warming = float(T[: max(kcp, 1), trop].mean(axis=1).max() - Ttrop[kcp])
    bcheck("mima_stratospheric_inversion", strat_warming,
           f"T rises {strat_warming:.0f} K above cold point", results)
    # subtropical jet
    nh = lats > 0
    kjet, jjet = np.unravel_index(np.argmax(u[:, nh]), u[:, nh].shape)
    bcheck("mima_jet_strength", float(u[:, nh].max()),
           f"NH jet {u[:, nh].max():.1f} m/s at {lats[nh][jjet]:.0f} deg",
           results)
    bcheck("mima_jet_latitude", float(lats[nh][jjet]),
           f"jet latitude {lats[nh][jjet]:.0f} deg", results)
    # warm moist tropics; the 100 m slab's t_surf is an equilibrium property
    # only past ~700 accumulated days
    ic_dominated = total_days < 700
    bcheck("mima_tropical_tsurf", float(ts[trop].mean()),
           f"tropical t_surf {ts[trop].mean():.1f} K after "
           f"{total_days:.0f} accumulated days"
           + (" [IC-dominated: run too short for slab equilibrium]"
              if ic_dominated else ""), results)
    results["mima_tropical_tsurf"]["ic_dominated"] = bool(ic_dominated)
    results["mima_tropical_tsurf"]["accumulated_days"] = round(total_days, 1)
    bcheck("mima_humidity", float(q[-1].max() * 1e3),
           f"sfc q max {q[-1].max()*1e3:.1f} g/kg", results)


# ---------------------------------------------------------------------------
# The state cache (isca_tpu's npz layout) and the chained run.
# ---------------------------------------------------------------------------

class WallBudget(Exception):
    """Raised when --max-wall-seconds is reached. The spinup/averaging state
    has already been checkpointed; the caller exits 0 so chained runs end
    cleanly."""


def state_leaf_keys(state) -> list[str]:
    """The state's keys of isca_tpu_torch.convert in isca_tpu's pytree
    order (dataclass and NamedTuple fields in order, dict entries by key):
    leaf i of a cache is the i-th key's array. A tracer-free PrimitiveState
    (Held-Suarez) or a GreyMoistState."""
    prim = [f"{n}_{lvl}" for n in PRIMITIVE_TWO_LEVEL for lvl in ("prev", "curr")]
    if isinstance(state, PrimitiveState):
        if state.tracers or state.spec_tracers:
            raise ValueError("state cache: a PrimitiveState with tracers has no "
                             "key list in isca_tpu_torch.convert")
        return prim + ["wg_full"]
    return (prim + ["sphum_prev", "sphum_curr", "wg_full", "t_surf", "time_seconds",
                    "bucket_depth_prev", "bucket_depth_curr", "tke"]
            + [f"rad_cache_{f}" for f in RadCache._fields])


def _is_spectral(key: str) -> bool:
    return key.rsplit("_", 1)[0] in PRIMITIVE_SPECTRAL


def state_to_leaves(state) -> list[np.ndarray]:
    """The state's leaves as numpy arrays in isca_tpu's order, complex ones
    as stacked (2, ...) real and imaginary parts."""
    d = (primitive_state_to_numpy(state) if isinstance(state, PrimitiveState)
         else grey_moist_state_to_numpy(state))
    out = []
    for k in state_leaf_keys(state):
        a = np.asarray(d[k])
        out.append(np.stack([a.real, a.imag]) if np.iscomplexobj(a) else a)
    return out


def state_from_leaves(leaves, template):
    """A state like `template` (same type, dtype and device) from leaves in
    isca_tpu's order, as state_to_leaves writes them."""
    keys = state_leaf_keys(template)
    d = {}
    for k, a in zip(keys, leaves):
        a = np.asarray(a)
        d[k] = (a[0] + 1j * a[1]) if _is_spectral(k) else a
    if isinstance(template, PrimitiveState):
        return primitive_state_from_numpy(d, template.ug.curr.dtype, template.ug.curr.device)
    return grey_moist_state_from_numpy(d, template.dyn.ug.curr.dtype,
                                       template.dyn.ug.curr.device)


def _committed(path) -> bool:
    """Whether `path` is one of the committed caches (exp/gate_cache/)."""
    return os.path.dirname(os.path.realpath(path)) == os.path.realpath(COMMITTED_CACHES)


def _checkpoint_path(cache):
    """Where a run that resumes from `cache` writes its checkpoints: the same
    name under .gate_cache/ when `cache` is a committed cache (read-only),
    else `cache` itself."""
    if cache is None:
        return None
    if _committed(cache):
        return os.path.join(WRITABLE_CACHES, os.path.basename(cache))
    return cache


def _save_state_cache(path, state, steps, fingerprint, avg_steps=0, accum=None):
    """Checkpoint a model state + RAW step counters to an npz (isca_tpu's
    layout). `steps` is the total number of model steps integrated into
    `state` (spinup AND averaging); `avg_steps` how many of them have been
    summed into the float64 accumulators `accum` (dict name -> array, or
    None before averaging starts). `fingerprint` (config dict) is stored
    and verified on load. Never writes under exp/gate_cache/."""
    if _committed(path):
        raise ValueError(f"{path}: the committed caches under exp/gate_cache/ are "
                         "read-only; checkpoint under .gate_cache/")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = state_to_leaves(state)
    payload = {f"leaf{i}": a for i, a in enumerate(leaves)}
    payload["steps"] = np.int64(steps)
    payload["avg_steps"] = np.int64(avg_steps)
    payload["nleaves"] = np.int64(len(leaves))
    payload["fingerprint"] = np.frombuffer(
        json.dumps(fingerprint, sort_keys=True).encode(), dtype=np.uint8)
    if accum is not None:
        for k, v in accum.items():
            payload[f"acc_{k}"] = np.asarray(v.cpu() if torch.is_tensor(v) else v,
                                             np.float64)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_state_cache(path, template, fingerprint):
    """Restore a checkpoint written by either package's _save_state_cache.
    Returns (state, steps, avg_steps, accum-or-None); ValueError on a
    fingerprint or leaf-count mismatch."""
    data = np.load(path, allow_pickle=False)
    if "steps" not in data.files:
        raise ValueError(f"{path}: legacy cache without raw step counters")
    saved_fp = json.loads(bytes(data["fingerprint"]).decode())
    want_fp = json.loads(json.dumps(fingerprint, sort_keys=True))
    if saved_fp != want_fp:
        raise ValueError(
            f"{path}: config fingerprint mismatch — cache was written with "
            f"{saved_fp}, this run is {want_fp}; refusing to splice "
            "incompatible trajectories")
    n = len(state_leaf_keys(template))
    if int(data["nleaves"]) != n:
        raise ValueError(f"{path}: cache has {int(data['nleaves'])} state leaves, "
                         f"model expects {n}")
    state = state_from_leaves([np.asarray(data[f"leaf{i}"]) for i in range(n)],
                              template)
    accum = {k[4:]: np.asarray(data[k], np.float64)
             for k in data.files if k.startswith("acc_")}
    return state, int(data["steps"]), int(data["avg_steps"]), (accum or None)


def _chained_spin_and_average(model, state, accum_fields, spin_steps,
                              avg_steps_target, cache=None, fingerprint=None,
                              deadline=None, progress=None):
    """Spinup + time-averaging with kill-safe chaining across runs.

    Integrates `spin_steps` of spinup then `avg_steps_target` of averaging in
    CH-step chunks. If `cache` is given, the state AND the float64 averaging
    sums checkpoint every ~10 minutes and at every phase boundary, so a
    killed run loses at most that much and a resumed chain reproduces an
    uninterrupted run step for step (counters are raw steps). A committed
    cache is read, and the checkpoints go to .gate_cache/ (_checkpoint_path).
    If `deadline` (epoch seconds) passes, checkpoints and raises WallBudget.
    The sums are float64 on the state's device, added every step. Returns
    (state, time-mean dict, total_steps)."""
    save_path = _checkpoint_path(cache)
    device = _device_of(state)
    steps, avg_done, accum = 0, 0, None
    resume = next((p for p in (save_path, cache) if p and os.path.exists(p)), None)
    if resume:
        state, steps, avg_done, acc_np = _load_state_cache(resume, state, fingerprint)
        if acc_np is not None:
            accum = {k: torch.as_tensor(v).to(device) for k, v in acc_np.items()}
        print(f"  resumed from {resume}: {steps} steps integrated "
              f"({avg_done} averaged)", flush=True)
    t0 = time.time()
    last_save = [t0]

    def save_cache():
        _sync(device)
        _save_state_cache(save_path, state, steps, fingerprint, avg_done, accum)
        last_save[0] = time.time()

    def checkpoint_maybe(phase):
        if save_path and time.time() - last_save[0] > 600:
            save_cache()
            print(f"  checkpoint [{phase}] step {steps} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if progress:
                progress(state, steps, phase)
        if deadline and time.time() > deadline:
            if save_path:
                save_cache()
            raise WallBudget(
                f"wall budget reached at step {steps} ({phase}); "
                + (f"state checkpointed to {save_path}" if save_path
                   else "no cache configured — progress lost"))

    last_rate = [time.time(), steps]

    def log_rate(phase):
        now = time.time()
        dsteps = steps - last_rate[1]
        if dsteps > 0 and now > last_rate[0]:
            print(f"  [{phase}] step {steps}: "
                  f"{dsteps / (now - last_rate[0]):.1f} steps/s "
                  f"({now - t0:.0f}s)", flush=True)
        last_rate[0], last_rate[1] = now, steps

    if steps == 0 and spin_steps > 0:
        state = model.run(state, CH, first=True)
        steps = CH
        _sync(device)
        print(f"  first chunk: {time.time() - t0:.0f}s", flush=True)
        last_rate = [time.time(), steps]
        checkpoint_maybe("spinup")
    while steps < spin_steps:
        state = model.run(state, CH, first=False)
        steps += CH
        _sync(device)
        if time.time() - last_rate[0] > 120:
            log_rate("spinup")
        checkpoint_maybe("spinup")
    if avg_done == 0:
        print(f"  spinup complete at step {steps} "
              f"({time.time() - t0:.0f}s)", flush=True)
        if save_path:
            save_cache()

    while avg_done < avg_steps_target:
        state, accum = _accumulate(model, state, accum_fields, accum, CH)
        steps += CH
        avg_done += CH
        _sync(device)
        if time.time() - last_rate[0] > 120:
            log_rate("averaging")
        checkpoint_maybe("averaging")
    if save_path:
        save_cache()
    print(f"  averaged {avg_done} steps ({time.time() - t0:.0f}s)", flush=True)
    if accum is None:
        accum = {k: torch.zeros(v.shape, dtype=torch.float64)
                 for k, v in accum_fields(state).items()}
    zm = {k: v.cpu().numpy() / max(avg_done, 1) for k, v in accum.items()}
    return state, zm, steps


def giant_model(resolution="T42", precision="highest", device=None):
    """The giant planet at a climate run's cutoff: 100 * T / 213 (the
    reference's T213 value scaled), not the trip test's 15. Returns (model,
    cutoff_wn)."""
    from isca_tpu_torch.models.giant import giant_planet_model

    trunc = int(str(resolution).lstrip("T"))
    cutoff = max(int(round(100 * trunc / 213)), 8)
    return giant_planet_model(resolution=resolution, num_levels=30, cutoff_wn=cutoff,
                              transform_precision=precision, device=device), cutoff


def giant_fingerprint(model, resolution, cutoff, precision):
    fingerprint = {"config": "giant", "resolution": str(resolution),
                   "num_levels": 30, "cutoff_wn": cutoff,
                   "dt": float(model.core.config.dt)}
    if precision != "highest":
        # only stamped when non-default, as isca_tpu's pre-existing
        # "highest" caches carry no such field
        fingerprint["transform_precision"] = precision
    return fingerprint


def giant_progress_line(model, state, steps, phase):
    """The gate's spin-up line: the upper (top 10 levels) equatorial (|lat| <
    8 deg) zonal-mean u at `steps`."""
    spd = int(86400 / model.core.config.dt)
    eq = np.abs(_lats_deg(model)) < 8
    u_eq = float(_zonal(state.dyn.ug.curr[:10]).cpu().numpy()[:, eq].mean())
    return f"  [{phase}] day {steps / spd:.1f}: upper equatorial u = {u_eq:+.1f} m/s"


def gate_giant(days, results, resolution="T42", cache=None, deadline=None,
               avg_days=None, precision="highest", device=None):
    """Giant planet (Schneider & Liu 2009, JAS): equatorial superrotation and
    multiple alternating off-equator jets. Three quarters of the days spin
    up, the rest (or avg_days) are averaged, chained through the cache. The
    criteria stay at SL09 magnitudes (see tools/climate_gate.py's gate_giant
    for what resolution and run length they need)."""
    precision = str(precision).lower()
    model, cutoff = giant_model(resolution, precision, device)
    state = model.initial_state()
    spd = int(86400 / model.core.config.dt)
    spin = (days * 3 // 4) * spd
    avg = (avg_days if avg_days else days - days * 3 // 4) * spd
    fingerprint = giant_fingerprint(model, resolution, cutoff, precision)

    def fields(st):
        return {"u": _zonal(st.dyn.ug.curr), "t": _zonal(st.dyn.tg.curr)}

    def progress(st, steps, phase):
        print(giant_progress_line(model, st, steps, phase), flush=True)

    t0 = time.time()
    state, zm, total_steps = _chained_spin_and_average(
        model, state, fields, spin, avg, cache=cache,
        fingerprint=fingerprint, deadline=deadline, progress=progress)
    wall = time.time() - t0
    print(f"Giant planet {resolution}L30: {total_steps / spd:.0f} total days "
          f"(target {days}) in {wall:.0f}s this run")

    lats = _lats_deg(model)
    u = zm["u"]
    L = u.shape[0]
    utop = u[: L // 3].mean(axis=0)        # upper-troposphere zonal-mean u
    eq = np.abs(lats) < 8

    bcheck("gp_equatorial_superrotation", float(utop[eq].mean()),
           f"equatorial upper u {utop[eq].mean():.0f} m/s (SL09: strong "
           "prograde)", results)
    # off-equator alternating jet pattern: count sign changes poleward of 10deg
    nh_off = utop[(lats > 10) & (lats < 80)]
    sh_off = utop[(lats < -10) & (lats > -80)]
    flips = int(np.sum(np.abs(np.diff(np.sign(nh_off))) > 0)
                + np.sum(np.abs(np.diff(np.sign(sh_off))) > 0))
    bcheck("gp_multiple_jets", float(flips),
           f"{flips} sign changes of off-equator zonal-mean u (alternating "
           "jets)", results)
    # equator dominates: superrotation exceeds the strongest midlat jet
    eq_ratio_min = BOUNDS["gp_equator_dominates"]["eq_over_max_midlat"][0]
    check("gp_equator_dominates",
          float(utop[eq].mean())
          > eq_ratio_min * float(np.abs(nh_off).max() + 1e-9),
          f"eq {utop[eq].mean():.0f} m/s vs max |midlat| {np.abs(nh_off).max():.0f}",
          results, value=float(utop[eq].mean()))
    # hemispheric symmetry of the jet pattern (statistical, loose)
    corr = float(np.corrcoef(nh_off[: len(sh_off)], sh_off[::-1][: len(nh_off)])[0, 1])
    bcheck("gp_hemispheric_symmetry", corr,
           f"NH/SH jet-pattern correlation {corr:.2f}", results)


def giant_resume(cache, days=1, resolution="T213", precision="high", device=None):
    """Continue a giant-planet chain (read-only: nothing is written) by
    `days` model days at leapfrog steps and print the gate's spin-up line
    before and after. Returns (line before, line after, ms per step)."""
    precision = str(precision).lower()
    model, cutoff = giant_model(resolution, precision, device)
    fingerprint = giant_fingerprint(model, resolution, cutoff, precision)
    state, steps, avg_steps, _ = _load_state_cache(cache, model.initial_state(), fingerprint)
    before = giant_progress_line(model, state, steps, "cache")
    print(f"  resumed from {cache}: {steps} steps integrated ({avg_steps} averaged)")
    print(before, flush=True)
    n = days * int(86400 / model.core.config.dt)
    device = _device_of(state)
    _sync(device)
    t0 = time.perf_counter()
    state = model.run(state, n, first=False)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / n
    after = giant_progress_line(model, state, steps + n, f"+{days} day at {precision}")
    print(after, flush=True)
    print(f"  {n} steps at {ms:.1f} ms per step", flush=True)
    if not all(bool(torch.isfinite(x).all()) for x in
               (state.dyn.ug.curr, state.dyn.vg.curr, state.dyn.tg.curr)):
        raise RuntimeError("giant_resume: the state is not finite after the resumed steps")
    return before, after, ms


def gate_realistic(days, results, resolution="T42", levels=None,
                   orbit_days_override=None, radiation="rrtm",
                   spin_orbits=None, device=None):
    """Realistic continents with a seasonal cycle (the reference
    exp/test_cases/realistic_continents capability: continental outlines +
    Sauliere 2012 topography + bucket hydrology + seasonal insolation +
    slab ocean with shallow land; namelist_basefile.nml's surface). RRTM
    with seasonal insolation and the constant ozone fallback (the
    reference's ozone_1990.nc is not in the repository), or
    radiation="grey". A full orbit is accumulated as four quarter-orbit
    windows; NH winter is the window with the coldest NH midlatitude land,
    summer the one half an orbit away. orbit_days_override shortens the
    orbit for a smoke run."""
    from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel
    from isca_tpu_torch.utils.land_generator import generate_land
    from isca_tpu_torch.utils.topography import band_limit_topography

    cfg = GreyMoistConfig()
    phys = dataclasses.replace(
        cfg.physics,
        bucket=True,
        radiation=dataclasses.replace(cfg.physics.radiation, do_seasonal=True),
        mixed_layer=dataclasses.replace(
            cfg.physics.mixed_layer,
            depth=20.0, land_option="input",
            land_h_capacity_prefactor=0.1,
            albedo_value=0.25, land_albedo_prefactor=1.3),
    )
    if radiation == "rrtm":
        # the reference case's own radiation settings (dt_rad=4320 = 6*dt,
        # solr_cnst=1360)
        from isca_tpu_torch.physics.rrtm_radiation import RRTMConfig
        phys = dataclasses.replace(
            phys, radiation_scheme="rrtm", dt_rad=4320.0,
            rrtm=RRTMConfig(do_seasonal=True, solr_cnst=1360.0))
        print("  ozone: constant fallback (reference input not in the repository)")
    if orbit_days_override is not None:  # fast smoke-test orbits
        phys = dataclasses.replace(
            phys, constants=dataclasses.replace(
                phys.constants,
                orbital_period=orbit_days_override * 86400.0))
    core = dataclasses.replace(cfg.core, resolution=resolution,
                               dtype=torch.float32,
                               **({"num_levels": levels} if levels else {}))
    model = GreyMoistModel(dataclasses.replace(cfg, core=core, physics=phys),
                           device=device)
    lats = np.degrees(_host(model.core.T.lats))
    lons = np.degrees(_host(model.core.T.lons))
    land, topo = generate_land(lats, lons, "continents", topo_mode="sauliere2012")
    # surface HEIGHT in meters, band-limited through the model truncation
    topo = band_limit_topography(model.core.T, np.asarray(topo),
                                 n_smooth_passes=2, smooth_fraction=0.02)
    model.set_land(land, surf_geopotential=topo)

    dt = model.core.config.dt
    spd = int(86400 / dt)
    orbit_s = model.config.physics.constants.orbital_period
    orbit_days = orbit_s / 86400.0
    # four windows tile one orbit; window 0 is centered on t = k*orbit
    window = max(int(round(orbit_days / 4.0 * spd)), 2)
    want_spin_days = max(days, int(1.5 * orbit_days))
    k = max(int(round((want_spin_days + orbit_days / 8.0) / orbit_days)), 2)
    if spin_orbits:
        k = max(int(spin_orbits), 1)
    spin = max(int(round(k * orbit_days * spd - window / 2.0)), 2 * spd)

    chunk = 240 if window >= 240 else max(window // 2, 1)
    state = model.initial_state()
    device = _device_of(state)

    def run_n(state, nsteps, first=False):
        t0, last = time.time(), time.time()
        if first:
            state = model.run(state, chunk, first=True)
            nsteps -= chunk
        done = chunk if first else 0
        for _ in range(max(nsteps // chunk, 0)):
            state = model.run(state, chunk, first=False)
            _sync(device)
            done += chunk
            if time.time() - last > 120:
                print(f"  ... step {done} ({(time.time() - t0):.0f}s)", flush=True)
                last = time.time()
        _sync(device)
        return state

    def accumulate(state, nsteps):
        n = max(nsteps // chunk, 1)
        acc = None
        fields = lambda s2: {"ts": s2.t_surf, "u": _zonal(s2.dyn.ug.curr),
                             "olr": s2.rad_cache.olr}
        for _ in range(n):
            state, acc = _accumulate(model, state, fields, acc, chunk)
            _sync(device)
        return state, tuple(acc[f].cpu().numpy() / (n * chunk) for f in ("ts", "u", "olr"))

    t0 = time.time()
    state = run_n(state, spin, first=True)
    print(f"  spinup {spin // spd} days: {time.time() - t0:.0f}s", flush=True)
    windows = []
    for w in range(4):
        state, acc = accumulate(state, window)
        windows.append(acc)
        print(f"  window {w} done ({time.time() - t0:.0f}s)", flush=True)
    total_days = (spin + 4 * window) // spd
    wall = time.time() - t0
    print(f"realistic continents {resolution}: {total_days} days in "
          f"{wall:.0f}s ({total_days * 86400 / wall:,.0f} model-days/day)")

    landm = np.asarray(land) > 0.5
    mid_nh = (lats >= 40) & (lats <= 65)
    band = np.zeros_like(landm)
    band[mid_nh, :] = True
    land_pts = landm & band
    ocean_pts = (~landm) & band

    # NH winter = window with coldest NH midlatitude land; summer = +half orbit
    land_means = [float(ts[land_pts].mean()) for ts, _, _ in windows]
    iw = int(np.argmin(land_means))
    isummer = (iw + 2) % 4
    ts_w, u_w, olr_w = windows[iw]
    ts_s, u_s, olr_s = windows[isummer]
    print(f"  window NH-land means {['%.1f' % m for m in land_means]} K "
          f"-> winter=window {iw}", flush=True)

    amp_land = float(np.abs(ts_w - ts_s)[land_pts].mean())
    amp_ocean = float(np.abs(ts_w - ts_s)[ocean_pts].mean())
    bcheck("realistic_land_seasonal_amplitude", amp_land,
           f"NH midlat land |winter-summer| t_surf {amp_land:.1f} K", results)
    bcheck("realistic_continentality_ratio",
           amp_land / max(amp_ocean, 1e-6),
           f"land/ocean seasonal amplitude ratio "
           f"{amp_land / max(amp_ocean, 1e-6):.2f} "
           f"(land {amp_land:.1f} K vs ocean {amp_ocean:.1f} K)", results)

    nh = lats > 20
    jet_w = float(u_w[:, nh].max())
    jet_s = float(u_s[:, nh].max())
    bcheck("realistic_winter_jet_stronger", jet_w / max(jet_s, 1e-6),
           f"NH jet winter {jet_w:.1f} vs summer {jet_s:.1f} m/s", results)
    for nm, (ts, _, _) in (("winter", windows[iw]),
                           ("summer", windows[isummer])):
        bcheck(f"realistic_tsurf_range_{nm}", float(ts.mean()),
               f"global-mean t_surf {nm} window: {ts.mean():.1f} K", results)
    if radiation == "rrtm":
        # annual-mean area-weighted OLR in the observed Earth range
        w = np.cos(np.radians(lats))[:, None]
        olr_ann = 0.5 * (olr_w + olr_s)
        olr_mean = float((olr_ann * w).sum() / (w.sum() * olr_ann.shape[1]))
        bcheck("realistic_olr", olr_mean,
               f"annual-mean OLR {olr_mean:.0f} W/m2 (radiation=rrtm, "
               "obs ~240)", results)


def merge_artifacts(paths, out):
    """Merge per-config gate artifacts (from --only runs) into one file.
    Criteria are unioned (later files win on key collisions), configs_run
    concatenated, wall times summed. Provenance (platform/device/power
    limit/date) and each source's own criteria go per-config into a 'runs'
    list, so two runs of one gate (two precisions) both stay whole."""
    _refuse_protected(out)
    merged = {"criteria": {}, "configs_run": [], "wall_seconds": 0.0,
              "runs": []}
    for path in paths:
        with open(path) as f:
            art = json.load(f)
        merged["criteria"].update(art.get("criteria", {}))
        merged["configs_run"].extend(
            c for c in art.get("configs_run", [])
            if c not in merged["configs_run"])
        merged.setdefault("transform_precision", {}).update(
            art.get("transform_precision", {}))
        merged["wall_seconds"] += art.get("wall_seconds", 0.0)
        if art.get("runs"):
            # already-merged artifact: carry its per-config provenance through
            merged["runs"].extend(art["runs"])
        else:
            merged["runs"].append({
                "source": os.path.basename(path),
                "configs": art.get("configs_run", []),
                "date": art.get("date"),
                "platform": art.get("platform"),
                "device_kind": art.get("device_kind"),
                "nvidia_smi": art.get("nvidia_smi"),
                "days_arg": art.get("days_arg"),
                "precision": art.get("precision"),
                "transform_precision": art.get("transform_precision"),
                "wall_seconds": art.get("wall_seconds"),
                "criteria": art.get("criteria", {}),
            })
    merged["passed"] = sum(r["pass"] for r in merged["criteria"].values())
    merged["total"] = len(merged["criteria"])
    versions = sorted({r.get("bounds_version", "pre-v5")
                       for r in merged["criteria"].values()})
    merged["bounds_version"] = versions[0] if len(versions) == 1 else versions
    merged["bounds_version_code"] = bounds_version()
    merged["date"] = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
    merged["platform"] = merged["runs"][0]["platform"] if merged["runs"] else None
    merged["device_kind"] = merged["runs"][0]["device_kind"] if merged["runs"] else None
    merged["nvidia_smi"] = merged["runs"][0].get("nvidia_smi") if merged["runs"] else None
    merged["wall_seconds"] = round(merged["wall_seconds"], 1)
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"merged {len(paths)} artifacts -> {out}: "
          f"{merged['passed']}/{merged['total']} criteria, "
          f"configs {merged['configs_run']}")
    return 0 if merged["passed"] == merged["total"] else 1


def _refuse_protected(path):
    if os.path.basename(path) in PROTECTED_JSON:
        raise SystemExit(f"{path}: the JAX tool's artifact; the port writes its own "
                         f"({DEFAULT_JSON})")


def _nvidia_smi(device) -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the card, None on the CPU."""
    if device.type != "cuda":
        return None
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[device.index or 0] if out.returncode == 0 and lines else None


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m isca_tpu_torch.climate_gate")
    p.add_argument("--days", type=int, default=1200,
                   help="Held-Suarez run length (Frierson/MiMA/giant scale off this)")
    p.add_argument("--json", default=DEFAULT_JSON,
                   help="artifact path ('' disables; never CLIMATE_GATE.json)")
    p.add_argument("--only", default="",
                   help="hs | frierson | mima | giant | realistic")
    p.add_argument("--resolution", default="T85", help="Held-Suarez truncation")
    p.add_argument("--giant-resolution", default="T42",
                   help="giant-planet truncation")
    p.add_argument("--giant-cache", default="",
                   help="state-cache npz for chaining the giant-planet spinup "
                        "across runs; resumed if present (a committed "
                        "exp/gate_cache/ one is read, and checkpoints go to "
                        ".gate_cache/)")
    p.add_argument("--giant-avg-days", type=int, default=0,
                   help="override the giant-planet averaging window "
                        "(days); 0 = default quarter of the run")
    p.add_argument("--giant-precision", default="highest",
                   help="transform_precision for the giant gate (goes into "
                        "the cache fingerprint: one chain = one precision)")
    p.add_argument("--giant-resume-days", type=int, default=0,
                   help="with --giant-cache: continue that chain by this many "
                        "days, writing nothing, print the spin-up line before "
                        "and after, and exit")
    p.add_argument("--realistic-radiation", default="rrtm",
                   choices=["rrtm", "grey"],
                   help="radiation for the realistic-continents gate")
    p.add_argument("--realistic-spin-orbits", type=int, default=0,
                   help="override the realistic gate's spinup length to this "
                        "many orbits before the four averaging windows "
                        "(default 0 = derived from --days, floor 2)")
    p.add_argument("--mima-cache", default="",
                   help="state-cache npz for chaining the MiMA spinup across "
                        "runs")
    p.add_argument("--hs-cache", default="",
                   help="state-cache npz for chaining the Held-Suarez run "
                        "across runs (resumed if present)")
    p.add_argument("--precision", default="highest",
                   help="transform_precision for the hs AND frierson gates")
    p.add_argument("--max-wall-seconds", type=float, default=0.0,
                   help="clean-stop budget: chained gates checkpoint and the "
                        "process exits 0 when this much wall clock has "
                        "elapsed (0 = no budget)")
    p.add_argument("--merge", nargs="+", metavar="JSON",
                   help="merge per-config artifacts into --json and exit")
    p.add_argument("--device", default=None,
                   help="where the models run: CUDA unless this names another "
                        "device (cpu)")
    args = p.parse_args(argv)

    if args.merge:
        return merge_artifacts(args.merge, args.json or DEFAULT_JSON)
    if args.json:
        _refuse_protected(args.json)
    device = resolve_device(args.device)
    if args.giant_resume_days:
        if not args.giant_cache:
            p.error("--giant-resume-days needs --giant-cache")
        giant_resume(args.giant_cache, args.giant_resume_days, args.giant_resolution,
                     args.giant_precision, device)
        return 0

    results = {}
    wanted = args.only.split(",") if args.only else ["hs", "frierson", "mima",
                                                     "giant", "realistic"]
    t0 = time.time()
    deadline = (t0 + args.max_wall_seconds) if args.max_wall_seconds else None
    gates = [
        ("hs", lambda: gate_held_suarez(args.days, results,
                                        resolution=args.resolution,
                                        precision=args.precision,
                                        cache=args.hs_cache or None,
                                        deadline=deadline, device=device)),
        ("frierson", lambda: gate_frierson(max(args.days // 2, 100), results,
                                           precision=args.precision, device=device)),
        ("giant", lambda: gate_giant(max(args.days * 6, 3000), results,
                                     resolution=args.giant_resolution,
                                     cache=args.giant_cache or None,
                                     deadline=deadline,
                                     avg_days=args.giant_avg_days or None,
                                     precision=args.giant_precision, device=device)),
        ("realistic", lambda: gate_realistic(
            max(args.days // 2, 300), results,
            radiation=args.realistic_radiation,
            spin_orbits=args.realistic_spin_orbits or None, device=device)),
        ("mima", lambda: gate_mima(max(args.days // 2, 100), results,
                                   cache=args.mima_cache or None,
                                   deadline=deadline, device=device)),
    ]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    smi = _nvidia_smi(device)
    done = []

    def write_artifact():
        npass = sum(r["pass"] for r in results.values())
        artifact = {
            "date": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
            "package": "isca_tpu_torch",
            "platform": "gpu" if device.type == "cuda" else device.type,
            "device_kind": kind,
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "days_arg": args.days,
            **({"realistic_spin_orbits": args.realistic_spin_orbits}
               if args.realistic_spin_orbits and "realistic" in done else {}),
            "precision": args.precision,
            "transform_precision": {
                c: (args.giant_precision if c == "giant"
                    else "highest" if c in ("mima", "realistic")
                    else args.precision)
                for c in done},
            "bounds_version": bounds_version(),
            "configs_run": list(done),
            "wall_seconds": round(time.time() - t0, 1),
            "passed": npass,
            "total": len(results),
            "criteria": results,
        }
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)

    wall_stopped = False
    for name, fn in gates:
        if name not in wanted:
            continue
        try:
            fn()
        except WallBudget as e:
            # clean stop: state is checkpointed; no FAIL recorded for an
            # intentionally segmented run, and no further gates started
            print(f"[wall budget] {e}", flush=True)
            wall_stopped = True
            break
        except Exception as e:  # one crashed config must not void the artifact
            import traceback
            traceback.print_exc()
            check(f"{name}_completed", False, f"gate crashed: {e!r}", results)
        done.append(name)
        if args.json:  # incremental: a later failure cannot void earlier configs
            write_artifact()
            print(f"wrote {args.json} ({', '.join(done)})")

    npass = sum(r["pass"] for r in results.values())
    print(f"\n{npass}/{len(results)} criteria passed"
          + (" (wall budget stop — chain incomplete)" if wall_stopped else ""))
    if wall_stopped:
        return 0
    return 0 if npass == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
