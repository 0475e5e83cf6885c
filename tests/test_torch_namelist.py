"""The port's namelist reader (isca_tpu_torch/namelist.py) against
tools/from_namelist.py and tests/test_from_namelist.py.

* Each case of tests/test_from_namelist.py on the port: the grammar, the
  diag table (the port's DiagTable), the Held-Suarez, Frierson and MiMA
  namelists' configurations, and a namelist-built Frierson model stepping
  bit for bit as the same configuration built by hand (T21L8 float64).
* For each exp/namelists/*.nml: the port's configuration equals
  tools.from_namelist's field by field (each port dataclass mapped to
  isca_tpu's class of the same name, torch dtypes to jax.numpy's), with
  the same warnings for unmapped keys, also on a namelist with such keys.
* The model built from frierson.nml at a T21L8 float64 override steps as
  isca_tpu's does over 5 steps at rtol 1e-9 of each leaf's largest entry.
* The CLI builds and prints the model (`--device cpu`).
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from isca_tpu_torch import namelist as tnml
from isca_tpu_torch.io.diag_manager import DiagTable
from isca_tpu_torch.utils.tree import flatten_with_paths
from tests.test_torch_gcm_ras import jax_leaves, one_torch_thread, to_jax  # noqa: F401
from tools import from_namelist as jnml

NML_DIR = os.path.join(os.path.dirname(__file__), "..", "exp", "namelists")
NAMELISTS = sorted(f for f in os.listdir(NML_DIR) if f.endswith(".nml"))
T21L8 = dict(resolution="T21", num_levels=8, dt=1200.0)


def text(name):
    with open(os.path.join(NML_DIR, name)) as fh:
        return fh.read()


def load(name):
    return tnml.parse_namelist(text(name))


def build(module, nml, **kw):
    """(model, the messages of the warnings raised while building it)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = module.model_from_namelist(nml, **kw)
    return model, [str(w.message) for w in caught if issubclass(w.category, UserWarning)]


# ---- tests/test_from_namelist.py's cases on the port --------------------------

def test_grammar():
    nml = tnml.parse_namelist("""
! comment
&grp_a
    x = 1, y = 2.5e-3
    s = 'hello ! not comment'
    flag = .true., other = F
    arr = 1., 2.,
          3., 4.
    rep = 3*0.5
    dexp = 1.5d2
/
&grp_b
   lst = 'a', 'b'
/
""")
    a = nml["grp_a"]
    assert a["x"] == 1 and a["y"] == 2.5e-3
    assert a["s"] == "hello ! not comment"
    assert a["flag"] is True and a["other"] is False
    assert a["arr"] == [1.0, 2.0, 3.0, 4.0]
    assert a["rep"] == [0.5, 0.5, 0.5]
    assert a["dexp"] == 150.0
    assert nml["grp_b"]["lst"] == ["a", "b"]


def test_diag_table():
    table = """
experiment name
2000 1 1 0 0 0
"atmos_monthly", 30, "days", 1, "days", "time",
"dynamics", "ps", "ps", "atmos_monthly", "all", .true., "none", 2,
"dynamics", "bk", "bk", "atmos_monthly", "all", .false., "none", 2,
"""
    dt = tnml.parse_diag_table(table)
    assert isinstance(dt, DiagTable)
    spec = dt.files["atmos_monthly"]
    assert spec.output_freq_seconds == 30 * 86400
    assert [f.name for f in spec.fields] == ["ps", "bk"]
    assert spec.fields[0].reduction == "average"
    assert spec.fields[1].reduction == "instantaneous"
    ref = jnml.parse_diag_table(table).files["atmos_monthly"]
    assert [(f.module, f.name, f.reduction) for f in spec.fields] == [
        (f.module, f.name, f.reduction) for f in ref.fields]


def test_held_suarez():
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        model = tnml.model_from_namelist(load("held_suarez.nml"), device="cpu")
    c = model.config
    assert type(model).__name__ == "HeldSuarezModel"
    core = c.core
    assert core.resolution == "T42" and core.num_levels == 25
    assert core.dt == 600.0 and core.damping_order == 4
    assert core.vert_coord_option == "uneven_sigma"
    assert dict(core.vert_coord_kwargs) == {
        "scale_heights": 6.0, "surf_res": 0.5, "exponent": 7.5}
    assert core.valid_range_t == (100.0, 800.0)
    assert core.reference_sea_level_press == 1.0e5
    f = c.forcing
    assert f.t_zero == 315.0 and f.sigma_b == 0.7 and f.kf == -1.0
    assert model.core.device == torch.device("cpu")


def test_frierson():
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        model = tnml.model_from_namelist(load("frierson.nml"), device="cpu")
    c = model.config
    assert type(model).__name__ == "GreyMoistModel"
    p = c.physics
    assert p.radiation_scheme == "two_stream"
    assert p.radiation.rad_scheme == "frierson"
    assert p.radiation.atm_abs == 0.2 and not p.radiation.do_seasonal
    assert p.convection_scheme == "SIMPLE_BETTS_MILLER"
    assert p.do_damping and p.turb and p.mixed_layer_bc
    assert p.roughness_mom == 3.21e-5
    assert p.do_simple_sat and p.bl_scheme == "diffusivity"
    assert p.gust_const == 0.0
    assert p.bl.do_simple and not p.surface.use_virtual_temp
    assert p.mixed_layer.depth == 2.5 and p.mixed_layer.albedo_value == 0.31
    assert p.mixed_layer.tconst == 285.0
    assert p.convection.rhbm == 0.7 and p.convection.Tmin == 160.0
    assert p.condensation.do_simple and p.condensation.do_evap
    assert p.damping.do_rayleigh and p.damping.trayfric == -0.25
    assert p.damping.sponge_pbottom == 5000.0
    assert c.core.dt == 720.0 and c.initial_sphum == 2e-6
    assert c.core.robert_coeff == 0.03
    assert c.core.do_water_correction


def test_mima():
    model = tnml.model_from_namelist(load("mima.nml"), device="cpu")
    c = model.config
    p = c.physics
    assert p.radiation_scheme == "rrtm"
    assert p.rrtm.solr_cnst == 1360
    assert p.dt_rad == 7200.0
    assert p.mixed_layer.depth == 100 and p.mixed_layer.albedo_value == 0.205
    assert p.mixed_layer.do_qflux and p.mixed_layer.qflux_amp == 30.0
    assert c.core.num_levels == 40
    assert dict(c.core.vert_coord_kwargs) == {
        "scale_heights": 11.0, "surf_res": 0.5, "exponent": 7.0}


def test_trajectory_identity_vs_handbuilt():
    """A namelist-built Frierson model steps bit for bit as the same
    configuration built by hand (T21L8, float64, the same overrides)."""
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.models.moist import GreyMoistConfig, GreyMoistModel

    overrides = dict(T21L8, dtype=torch.float64)
    nml_model = tnml.model_from_namelist(load("frierson.nml"), device="cpu", **overrides)
    hand_core = PrimitiveConfig(
        damping_order=4, water_correction_limit=200.0e2,
        reference_sea_level_press=1.0e5, valid_range_t=(100.0, 800.0),
        vert_coord_option="uneven_sigma",
        vert_coord_kwargs=(("scale_heights", 6.0), ("surf_res", 0.5), ("exponent", 7.5)),
        robert_coeff=0.03, do_water_correction=True, use_virtual_temperature=False,
        **overrides)
    hand = GreyMoistModel(GreyMoistConfig(core=hand_core, physics=nml_model.config.physics,
                                          initial_sphum=2e-6), device="cpu")
    assert hand.config.core == nml_model.config.core
    s_nml = nml_model.run(nml_model.initial_state(), 6)
    s_hand = hand.run(hand.initial_state(), 6)
    assert torch.equal(s_nml.dyn.tg.curr, s_hand.dyn.tg.curr)
    assert torch.equal(s_nml.t_surf, s_hand.t_surf)


# ---- the port against tools/from_namelist.py ------------------------------------

@pytest.mark.parametrize("name", NAMELISTS)
def test_config_equals_tools_from_namelist(name):
    """The port's configuration of each reference namelist is isca_tpu's,
    field by field (dtype mapped), and both warn alike (not at all here)."""
    nml_t, nml_j = tnml.parse_namelist(text(name)), jnml.parse_namelist(text(name))
    assert nml_t == nml_j
    tm, t_warn = build(tnml, nml_t, device="cpu")
    jm, j_warn = build(jnml, nml_j)
    assert type(tm).__name__ == type(jm).__name__
    assert to_jax(tm.config) == jm.config
    assert t_warn == j_warn


def test_unmapped_keys_warn_alike():
    """A key that maps nowhere warns (value dropped) in both, with the same
    message; an obsolete group and a dropped key do not."""
    bad = text("frierson.nml").replace(
        "&mixed_layer_nml\n", "&mixed_layer_nml\n    no_such_key = 3,\n").replace(
        "&damping_driver_nml\n", "&damping_driver_nml\n    also_unmapped = .true.,\n")
    _, t_warn = build(tnml, tnml.parse_namelist(bad), device="cpu")
    _, j_warn = build(jnml, jnml.parse_namelist(bad))
    assert t_warn == j_warn and len(t_warn) == 2
    assert any("mixed_layer_nml.no_such_key" in w for w in t_warn)


def test_frierson_namelist_steps_as_isca_tpu():
    """frierson.nml at a T21L8 float64 override: 5 steps of the port's model
    against isca_tpu's, every leaf at rtol 1e-9 of its largest entry."""
    tm = tnml.model_from_namelist(load("frierson.nml"), device="cpu",
                                  **T21L8, dtype=torch.float64)
    jm = jnml.model_from_namelist(jnml.parse_namelist(text("frierson.nml")),
                                  **T21L8, dtype=to_jax(torch.float64))
    assert to_jax(tm.config) == jm.config
    ts = tm.run(tm.initial_state(), 5)
    js = jax_leaves(jax.jit(lambda s: jm.run(s, 5))(jm.initial_state()))
    got = {k: v.numpy() for k, v in flatten_with_paths(ts)}
    assert set(got) == set(js)
    for k, b in js.items():
        scale = float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(got[k], b, rtol=0, atol=1e-9 * scale, err_msg=k)


def test_cli_builds_and_prints(capsys, tmp_path):
    table = tmp_path / "diag_table"
    table.write_text('title\n2000 1 1 0 0 0\n"atmos_daily", 1, "days", 1, "days", "time",\n'
                     '"dynamics", "ps", "ps", "atmos_daily", "all", .true., "none", 2,\n')
    assert tnml.main([os.path.join(NML_DIR, "held_suarez.nml"), str(table),
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("model: HeldSuarezModel")
    assert "diag file atmos_daily: every 86400s, 1 fields" in out
