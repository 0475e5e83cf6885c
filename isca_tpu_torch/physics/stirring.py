"""Stochastic vorticity stirring (Vallis et al. 2004, JAS 61, 264).

Port of isca_tpu/physics/stirring.py (reference:
src/atmos_spectral_barotropic/stirring.F90). A red-noise (AR(1)) forcing
in a spectral annulus, optionally localized in physical space by a grid-space
round trip:

    a = sqrt(1 - exp(-2 dt/tau)),  b = exp(-dt/tau)
    eta_mn ~ amplitude * a * Uniform(-1,1) + i Uniform(-1,1)   on masked modes
    eta   <- analyze( localize(lat,lon) * synthesize(eta) ),  eta_00 = 0
    s     <- b * s + eta            (carried state; Vallis et al. eq. A.6)
    dt_vors += s

The draws are isca_tpu's to the bit: a threaded uint32[2] key, split and
drawn by the port's threefry (utils/threefry.py) as jax.random does. On a
mesh every rank draws the whole (M+1, N+2) field and keeps its m rows, so
the sharded run is stirred as the run on one device is; the localisation
round trip runs through the sharded transforms. Each update runs inside a
profiler range named "stirring".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from isca_tpu_torch.spectral import transforms as tr
from isca_tpu_torch.utils import threefry


@dataclasses.dataclass(frozen=True)
class Stirring:
    mask: torch.Tensor      # (M+1, N+2) 1.0 on forced modes
    localize: torch.Tensor  # (nlat, nlon) spatial envelope
    amplitude: float
    a: float                # sqrt(1 - exp(-2 dt / decay_time))
    b: float                # exp(-dt / decay_time)
    do_localize: bool


def make_stirring(
    T: tr.SphericalTransforms,
    dt: float,
    amplitude: float = 0.0,
    decay_time: float = 2 * 86400.0,
    lat0: float = 45.0,
    lon0: float = 180.0,
    widthy: float = 12.0,
    widthx: float = 45.0,
    B: float = 0.0,
    do_localize: bool = True,
    n_total_forcing_max: int = 15,
    n_total_forcing_min: int = 9,
    zonal_forcing_min: int = 3,
) -> Stirring:
    M, N2 = T.num_fourier, T.num_spherical + 1
    m = np.arange(M + 1)[:, None]
    n = np.arange(N2)[None, :]
    mask = (m > zonal_forcing_min) & (n > n_total_forcing_min) & (n < n_total_forcing_max)
    mask &= n >= m
    # this rank's m rows; never force outside the prognostic triangle
    # (keeps padded m rows zero)
    mask = T.local_m(mask) & (T.triangle.cpu().numpy() > 0.0)

    # in the tables' own dtype, as isca_tpu computes it from its tables
    lat_deg = np.degrees(T.lats.cpu().numpy())
    lon_deg = np.degrees(T.lons.cpu().numpy())
    xx = lon_deg - lon0
    xx = xx - 360.0 * np.rint(xx / 360.0)
    ampx = 1.0 + B * np.exp(-0.5 * (xx / widthx) ** 2)
    ampy = np.exp(-0.5 * ((lat_deg - lat0) / widthy) ** 2)
    localize = ampy[:, None] * ampx[None, :] if do_localize else np.ones(T.grid_shape)

    f = lambda x: torch.as_tensor(np.asarray(x)).to(device=T.device, dtype=T.dtype)
    return Stirring(
        mask=f(mask.astype(np.float64)),
        localize=f(localize),
        amplitude=float(amplitude),
        a=float(np.sqrt(1.0 - np.exp(-2.0 * dt / decay_time))),
        b=float(np.exp(-dt / decay_time)),
        do_localize=bool(do_localize),
    )


def stir(S: Stirring, T: tr.SphericalTransforms, s_stir: torch.Tensor,
         key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One stirring update: returns (new s_stir, new key). Add s_stir to dt_vors."""
    if S.amplitude == 0.0:
        return s_stir, key
    with record_function("stirring"):
        key, sub = threefry.split(key)
        whole = (T.num_fourier + 1, T.num_spherical + 1, 2)
        ran = T.local_m(threefry.uniform(sub, whole, T.dtype, -1.0, 1.0))
        new = S.amplitude * S.a * torch.complex(ran[..., 0], ran[..., 1]) * S.mask
        if S.do_localize:
            new = tr.grid_to_spec(T, S.localize * tr.spec_to_grid(T, new))
            if T.m_start == 0:
                new[0, 0] = 0.0
        return S.b * s_stir + new, key
