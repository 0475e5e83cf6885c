"""McICA: Monte-Carlo Independent Column Approximation subcolumn generator.

Port of isca_tpu/physics/mcica.py (reference: src/atmos_param/rrtm_radiation/
rrtmg_lw/gcm_model/src/mcica_subcol_gen_lw.f90, generate_stochastic_clouds
:196-523, and the SW twin). Each g-point gets one stochastic binary
subcolumn: a uniform random CDF per (subcolumn, column, layer) is
transformed by the overlap assumption, a subcolumn layer is cloudy where
CDF >= 1 - cldfrac, and cloudy subcolumn layers carry the full in-cloud
condensate (cloud fraction 1), clear ones zero.

Overlap options (icld): 1 = random, 2 = maximum-random (default), 3 = maximum
(mcica_subcol_gen_lw.f90:352-460).

The draws are `jax.random.uniform(key, shape, dtype)`'s bit for bit
(`utils/threefry.py`), so a key gives the same subcolumns in both packages.
isca_tpu's maximum-random `lax.scan` over layers is a level loop here.
"""

from __future__ import annotations

import torch

from isca_tpu_torch.utils import threefry


def mcica_subcol(key, cldfrac, clwp, ciwp, nsubcol, overlap=2):
    """Generate stochastic binary subcolumns.

    key: a uint32[2] threefry key (jax.random.PRNGKey's layout) on the
    fields' device. cldfrac/clwp/ciwp: (..., L) grid-mean cloud fraction and
    IN-CLOUD water paths, layers TOP-DOWN (overlap walks top->bottom: adjacent
    cloudy layers share their random draw).

    Returns (cldf_mc, clwp_mc, ciwp_mc), each (..., L, nsubcol); cldf_mc is
    binary {0,1}.
    """
    cldf = torch.where(cldfrac < 1.0e-20, 0.0, cldfrac)
    shape = cldf.shape + (nsubcol,)
    cdf = threefry.uniform(key, shape, dtype=cldf.dtype)

    if overlap == 2:
        # maximum-random: reuse the neighbour's draw where it was cloudy,
        # else rescale this layer's draw into the clear part
        # (mcica_subcol_gen_lw.f90:404-414)
        levels = [cdf[..., 0, :]]
        for l in range(1, cdf.shape[-2]):
            prev, clear_prev = levels[-1], 1.0 - cldf[..., l - 1, None]
            levels.append(torch.where(prev > clear_prev, prev,
                                      cdf[..., l, :] * clear_prev))
        cdf = torch.stack(levels, dim=-2)
    elif overlap == 3:
        # maximum: one draw per subcolumn for the whole column
        cdf = cdf[..., :1, :].expand(shape)
    # overlap == 1 (random): independent draws, nothing to do

    iscloudy = cdf >= 1.0 - cldf[..., None]
    cldf_mc = iscloudy.to(cldf.dtype)
    clwp_mc = torch.where(iscloudy, clwp[..., None], 0.0)
    ciwp_mc = torch.where(iscloudy, ciwp[..., None], 0.0)
    return cldf_mc, clwp_mc, ciwp_mc
