"""Giant-planet (Jupiter-like) configuration.

Port of isca_tpu/models/giant.py (reference:
exp/test_cases/giant_planet/giant_planet_test_case.py with the
SocratesCodeBase swapped for grey radiation): Schneider & Liu (2009)
two-stream scheme, dry convective adjustment, giant-planet lower boundary
(interior heat flux + Rayleigh bottom drag, no slab ocean), upper sponge,
Jupiter constants via constants_nml-equivalent (radius/gravity/rotation flow
into the transforms and dycore).
"""

from __future__ import annotations

import torch

from isca_tpu_torch.constants import Constants
from isca_tpu_torch.dycore.primitive import PrimitiveConfig
from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel
from isca_tpu_torch.physics.damping_driver import DampingDriverConfig
from isca_tpu_torch.physics.dry_convection import DryConvectionConfig
from isca_tpu_torch.physics.giant_planet import GiantPlanetConfig
from isca_tpu_torch.physics.mixed_layer import MixedLayerConfig
from isca_tpu_torch.physics.moist_driver import MoistPhysicsConfig
from isca_tpu_torch.physics.two_stream_gray import TwoStreamConfig

JUPITER = Constants(
    radius=69860.0e3,
    grav=26.0,
    omega=1.7587e-4,
    rdgas=3605.38,
    cp_air=3605.38 / (2.0 / 7.0),
    kappa=2.0 / 7.0,
    pstd=3.0e6,
    pstd_mks=3.0e5,
    orbital_period=4332.589 * 86400.0,
    solar_const=50.7,
)


def giant_planet_model(
    resolution="T42", num_levels=30, dt=1800.0, dtype=None, cutoff_wn=15,
    transform_precision="highest", device=None, mesh=None,
) -> GreyMoistModel:
    """Build the giant-planet model (reduced resolution by default; the
    reference test case runs T213L30 with dt=1800).

    Faithful to the reference namelist (giant_planet_test_case.py:150-200,
    where duplicate dict keys resolve to the LAST value):
    reference_sea_level_press=3.0e5 (3 bar: at pstd_mks=3e5 this puts the
    surface LW optical depth at lw_tau_0_gp=80, the Schneider & Liu 2009
    interior greenhouse), exponential-cutoff hyperdiffusion with
    damping_coeff=1.3889e-4 (cutoff_wn=15 is the reference trip test's own
    T42 reduction, trip_test_functions.py:50-55; the T213 case uses 100),
    and the rayleigh_bottom_drag module defaults (sigma_b=0.85).
    device: None runs on CUDA (and raises without it); "cpu" on the CPU.
    mesh: an isca_tpu_torch.parallel.mesh.Mesh shards the model
    (PrimitiveConfig(mesh=...)): each rank steps its latitude band and m
    block; the giant-planet surface and dry convection are column-local."""
    core = PrimitiveConfig(
        resolution=resolution,
        num_levels=num_levels,
        dt=dt,
        vert_coord_option="even_sigma",
        reference_sea_level_press=3.0e5,
        valid_range_t=(50.0, 800.0),
        damping_option="exponential_cutoff",
        damping_order=4,
        damping_coeff=1.3889e-4,
        cutoff_wn=cutoff_wn,
        robert_coeff=0.03,
        initial_temperature=200.0,
        do_water_correction=False,
        constants=JUPITER,
        dtype=dtype or torch.float32,
        transform_precision=transform_precision,
        mesh=mesh,
    )
    physics = MoistPhysicsConfig(
        convection_scheme="DRY",
        gp_surface=True,
        mixed_layer_bc=False,
        do_damping=True,
        turb=True,
        roughness_mom=3.21e-5,
        roughness_heat=3.21e-5,
        roughness_moist=3.21e-5,
        radiation=TwoStreamConfig(
            rad_scheme="schneider", solar_constant=50.7, constants=JUPITER,
        ),
        dry_convection=DryConvectionConfig(tau=21600.0, gamma=1.0, constants=JUPITER),
        giant=GiantPlanetConfig(constants=JUPITER),
        damping=DampingDriverConfig(sponge_pbottom=50.0, constants=JUPITER),
        mixed_layer=MixedLayerConfig(constants=JUPITER),
        constants=JUPITER,
    )
    return GreyMoistModel(GreyMoistConfig(core=core, physics=physics,
                                          t_surf_init=200.0,
                                          initial_sphum=0.0), device=device)
