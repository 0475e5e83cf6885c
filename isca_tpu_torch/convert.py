"""Carries a model state between isca_tpu and isca_tpu_torch.

A state travels as a dict of numpy arrays, so neither package imports the
other. The same dict built from an isca_tpu state (np.asarray of each leaf)
starts both packages from identical state.

* Column model: `t_prev`, `t_curr`, `q_prev`, `q_curr`, `u_prev`, `u_curr`,
  `v_prev`, `v_curr` (lat, lon, L), `t_surf` (lat, lon) and `time_seconds` (0-d).
* Primitive-equation core (tracer-free): `<name>_prev` and `<name>_curr` for
  each two-level field of PrimitiveState (PRIMITIVE_TWO_LEVEL: the complex
  spectral vors, divs, ts (L, m, n) and lnps (m, n); the grid ug, vg, tg,
  vorg, divg (L, lat, lon) and psg (lat, lon)), and `wg_full` (L, lat, lon).
* Grey moist model: the primitive keys of its `dyn`, `sphum_prev` and
  `sphum_curr` (L, lat, lon), `t_surf` (lat, lon), `time_seconds` (0-d
  float32), `bucket_depth_prev` and `bucket_depth_curr` (lat, lon), `tke`
  (lat, lon, L+1) and `rad_cache_<field>` for each field of RadCache
  (`rad_cache_age` 0-d int32).
* Barotropic and shallow-water models: `<name>_prev` and `<name>_curr` for
  each two-level field (BAROTROPIC_TWO_LEVEL, SHALLOW_TWO_LEVEL: complex
  spectral (m, n) or grid (lat, lon)), `s_stir` (complex (m, n)) and `rng`,
  the uint32[2] stirring key.
"""

from __future__ import annotations

import numpy as np
import torch

from isca_tpu_torch import resolve_device
from isca_tpu_torch.dycore.primitive import PrimitiveState
from isca_tpu_torch.dycore.time_integration import TwoLevel
from isca_tpu_torch.models.barotropic import BarotropicState
from isca_tpu_torch.models.column import ColumnState
from isca_tpu_torch.models.moist import GreyMoistState
from isca_tpu_torch.models.shallow import ShallowState
from isca_tpu_torch.physics.moist_driver import RadCache

PROGNOSTIC = ("t", "q", "u", "v")
STATE_KEYS = tuple(f"{n}_{lvl}" for n in PROGNOSTIC for lvl in ("prev", "curr")) + (
    "t_surf", "time_seconds")


def column_state_from_numpy(d, dtype=torch.float32, device=None) -> ColumnState:
    """A ColumnState on `device` in `dtype`; time_seconds stays float32."""
    device = resolve_device(device)
    missing = set(STATE_KEYS) - set(d)
    if missing:
        raise KeyError(f"column state is missing {sorted(missing)}")
    as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(device, dt)
    two = lambda n: TwoLevel(as_t(d[f"{n}_prev"]), as_t(d[f"{n}_curr"]))
    return ColumnState(
        t=two("t"), q=two("q"), u=two("u"), v=two("v"),
        t_surf=as_t(d["t_surf"]),
        time_seconds=as_t(d["time_seconds"], torch.float32))


def column_state_to_numpy(state: ColumnState) -> dict:
    """The state as a dict of numpy arrays (keys STATE_KEYS)."""
    out = {}
    for n in PROGNOSTIC:
        pair = getattr(state, n)
        out[f"{n}_prev"] = pair.prev.detach().cpu().numpy()
        out[f"{n}_curr"] = pair.curr.detach().cpu().numpy()
    out["t_surf"] = state.t_surf.detach().cpu().numpy()
    out["time_seconds"] = state.time_seconds.detach().cpu().numpy()
    return out


PRIMITIVE_SPECTRAL = ("vors", "divs", "ts", "lnps")
PRIMITIVE_TWO_LEVEL = PRIMITIVE_SPECTRAL + ("ug", "vg", "tg", "psg", "vorg", "divg")
PRIMITIVE_STATE_KEYS = tuple(
    f"{n}_{lvl}" for n in PRIMITIVE_TWO_LEVEL for lvl in ("prev", "curr")) + ("wg_full",)


def primitive_state_from_numpy(d, dtype=torch.float32, device=None) -> PrimitiveState:
    """A tracer-free PrimitiveState on `device`: grid fields in `dtype`,
    spectral fields in the complex type of the same precision."""
    device = resolve_device(device)
    missing = set(PRIMITIVE_STATE_KEYS) - set(d)
    if missing:
        raise KeyError(f"primitive state is missing {sorted(missing)}")
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    as_t = lambda k: torch.as_tensor(np.array(d[k])).to(
        device, cdtype if k.rsplit("_", 1)[0] in PRIMITIVE_SPECTRAL else dtype)
    two = {n: TwoLevel(as_t(f"{n}_prev"), as_t(f"{n}_curr")) for n in PRIMITIVE_TWO_LEVEL}
    return PrimitiveState(**two, tracers={}, spec_tracers={}, wg_full=as_t("wg_full"))


def primitive_state_to_numpy(state: PrimitiveState) -> dict:
    """The state as a dict of numpy arrays (keys PRIMITIVE_STATE_KEYS)."""
    out = {}
    for n in PRIMITIVE_TWO_LEVEL:
        pair = getattr(state, n)
        out[f"{n}_prev"] = pair.prev.detach().cpu().numpy()
        out[f"{n}_curr"] = pair.curr.detach().cpu().numpy()
    out["wg_full"] = state.wg_full.detach().cpu().numpy()
    return out


GREY_MOIST_STATE_KEYS = PRIMITIVE_STATE_KEYS + (
    "sphum_prev", "sphum_curr", "t_surf", "time_seconds",
    "bucket_depth_prev", "bucket_depth_curr", "tke",
) + tuple(f"rad_cache_{f}" for f in RadCache._fields)


def grey_moist_state_from_numpy(d, dtype=torch.float32, device=None) -> GreyMoistState:
    """A GreyMoistState on `device`: real fields in `dtype`, spectral fields
    in its complex type, time_seconds float32 and rad_cache_age int32."""
    device = resolve_device(device)
    missing = set(GREY_MOIST_STATE_KEYS) - set(d)
    if missing:
        raise KeyError(f"grey moist state is missing {sorted(missing)}")
    dyn = primitive_state_from_numpy(d, dtype, device)
    as_t = lambda k, dt=dtype: torch.as_tensor(np.array(d[k])).to(device, dt)
    two = lambda n: TwoLevel(as_t(f"{n}_prev"), as_t(f"{n}_curr"))
    dyn.tracers["sphum"] = two("sphum")
    rad = RadCache(**{f: as_t(f"rad_cache_{f}", torch.int32 if f == "age" else dtype)
                      for f in RadCache._fields})
    return GreyMoistState(
        dyn=dyn, t_surf=as_t("t_surf"), time_seconds=as_t("time_seconds", torch.float32),
        bucket_depth=two("bucket_depth"), tke=as_t("tke"), rad_cache=rad)


def grey_moist_state_to_numpy(state: GreyMoistState) -> dict:
    """The state as a dict of numpy arrays (keys GREY_MOIST_STATE_KEYS)."""
    host = lambda x: x.detach().cpu().numpy()
    out = primitive_state_to_numpy(state.dyn)
    for n, pair in (("sphum", state.dyn.tracers["sphum"]), ("bucket_depth", state.bucket_depth)):
        out[f"{n}_prev"], out[f"{n}_curr"] = host(pair.prev), host(pair.curr)
    out["t_surf"] = host(state.t_surf)
    out["time_seconds"] = host(state.time_seconds)
    out["tke"] = host(state.tke)
    for f in RadCache._fields:
        out[f"rad_cache_{f}"] = host(getattr(state.rad_cache, f))
    return out


BAROTROPIC_SPECTRAL = ("vors", "trs")
BAROTROPIC_TWO_LEVEL = BAROTROPIC_SPECTRAL + ("u", "v", "vorg")
SHALLOW_SPECTRAL = ("vors", "divs", "hs", "trs")
SHALLOW_TWO_LEVEL = ("vors", "divs", "hs", "u", "v", "vorg", "divg", "hg", "trs")


def _simple_keys(two_level):
    return tuple(f"{n}_{lvl}" for n in two_level for lvl in ("prev", "curr")) + (
        "s_stir", "rng")


BAROTROPIC_STATE_KEYS = _simple_keys(BAROTROPIC_TWO_LEVEL)
SHALLOW_STATE_KEYS = _simple_keys(SHALLOW_TWO_LEVEL)


def _simple_from_numpy(cls, two_level, spectral, d, dtype, device):
    device = resolve_device(device)
    missing = set(_simple_keys(two_level)) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} is missing {sorted(missing)}")
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    as_t = lambda k, dt: torch.as_tensor(np.array(d[k])).to(device, dt)
    two = {n: TwoLevel(*(as_t(f"{n}_{lvl}", cdtype if n in spectral else dtype)
                         for lvl in ("prev", "curr"))) for n in two_level}
    return cls(**two, s_stir=as_t("s_stir", cdtype),
               rng=as_t("rng", torch.int64).to(torch.uint32))


def _simple_to_numpy(state, two_level) -> dict:
    host = lambda x: x.detach().cpu().numpy()
    out = {}
    for n in two_level:
        pair = getattr(state, n)
        out[f"{n}_prev"], out[f"{n}_curr"] = host(pair.prev), host(pair.curr)
    out["s_stir"], out["rng"] = host(state.s_stir), host(state.rng)
    return out


def barotropic_state_from_numpy(d, dtype=torch.float32, device=None) -> BarotropicState:
    """A BarotropicState on `device`: grid fields in `dtype`, spectral fields
    and s_stir in its complex type, rng uint32."""
    return _simple_from_numpy(BarotropicState, BAROTROPIC_TWO_LEVEL, BAROTROPIC_SPECTRAL,
                              d, dtype, device)


def barotropic_state_to_numpy(state: BarotropicState) -> dict:
    """The state as a dict of numpy arrays (keys BAROTROPIC_STATE_KEYS)."""
    return _simple_to_numpy(state, BAROTROPIC_TWO_LEVEL)


def shallow_state_from_numpy(d, dtype=torch.float32, device=None) -> ShallowState:
    """A ShallowState on `device`: grid fields in `dtype`, spectral fields and
    s_stir in its complex type, rng uint32."""
    return _simple_from_numpy(ShallowState, SHALLOW_TWO_LEVEL, SHALLOW_SPECTRAL,
                              d, dtype, device)


def shallow_state_to_numpy(state: ShallowState) -> dict:
    """The state as a dict of numpy arrays (keys SHALLOW_STATE_KEYS)."""
    return _simple_to_numpy(state, SHALLOW_TWO_LEVEL)
