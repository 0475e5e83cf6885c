"""The transform precision modes of isca_tpu_torch (spectral/precision.py)
against a numpy bit-level reference, float64 products and isca_tpu.

* round_to_tf32 equals a numpy reference on the bits (round to nearest,
  ties to even, on the 13 low mantissa bits), ties, inf and NaN included.
* Each mode's product against the float64 product within its bound, for
  K terms of |a||b|: "highest" K u, "high" (2^-20 + 3K u), "default"
  (2^-10 + K u), with u = 2^-24 (a TF32 part carries 11 bits, so one part's
  rounding costs 2^-11 relative, two 2^-10; "high" drops only lo x lo and
  lo's own rounding, 2^-22 each). The float32 "high" and "default" products
  differ from "highest".
* Float64 transforms are the same at every mode, bit for bit.
* The float32 transforms at every mode against isca_tpu's at the same mode
  (on the CPU isca_tpu computes exact products at every mode, its modes
  bit-equal): "highest" and "high" within 2e-6 of the largest entry (FP32
  sums in another order), "default" within 2e-3 (one TF32 rounding of each
  operand). The mesh branch (2 gloo ranks) equals one device to 1e-6.
* Held-Suarez at T21L8 float32, 10 steps at "high", against isca_tpu at
  "high" (exact on the CPU) by the dycore tests' float32 rule scaled for
  3xTF32: within 3 x 4 = 12x isca_tpu's own float32-versus-float64
  difference per field. The 4 is 2^(24-22): the two TF32 parts leave
  2^-22 of each operand where FP32 rounding leaves 2^-24. Measured: 4.3x at
  worst (vor); "highest" stays within 2x, as the 3x rule has it.
* Every model that takes transform_precision (Held-Suarez, barotropic,
  shallow water, the giant planet, the Frierson and MiMA configurations)
  builds at "high" and "default", and all but MiMA take 2 finite float32
  steps.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.spectral import transforms as jtr
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.models.dry import HeldSuarezConfig as THSC
from isca_tpu_torch.models.dry import HeldSuarezModel as THSM
from isca_tpu_torch.parallel.mesh import spawn
from isca_tpu_torch.spectral import precision as prec
from isca_tpu_torch.spectral import transforms as ttr

import torch_precision_cases as cases

U = 2.0 ** -24
MODE_BOUND = {"highest": 0.0, "high": 2.0 ** -20, "default": 2.0 ** -10}
# terms summed in FP32 per output: K, and 3K for "high" (its three passes)
TERMS = {"highest": 1, "high": 3, "default": 1}
TRANSFORM_TOL = {"highest": 2e-6, "high": 2e-6, "default": 2e-3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager small-grid steps are many small ops: one intra-op thread runs
    them faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tf32(x):
    """Bit-level reference: float32 -> nearest TF32, ties to even."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), r, x)


def test_round_to_tf32_matches_numpy_bits():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-40, 38, 20000)).astype(np.float32)
    # exact ties (the 13 dropped bits are 1000000000000) on both parities of
    # the kept last bit, both signs, with the carry into the exponent, and
    # the specials
    mant = rng.integers(0, 1 << 10, 400, dtype=np.uint32) << 13
    ties = (np.uint32(0x3F800000) | mant | np.uint32(0x1000)).view(np.float32)
    carry = np.array([0x3FFFF000, 0x7F7FF000, 0x7F7FFFFF, 0x00001000, 0x00003000],
                     np.uint32).view(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45], np.float32)
    x = np.concatenate([x, ties, -ties, carry, -carry, special])
    with np.errstate(over="ignore"):
        ref = numpy_tf32(x)
    got = prec.round_to_tf32(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.uint32)[np.isfinite(ref)],
                          ref.view(np.uint32)[np.isfinite(ref)])
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(got[np.isinf(ref)], ref[np.isinf(ref)])
    assert not (got.view(np.uint32)[np.isfinite(got)] & 0x1FFF).any()
    # the parities of ties: even kept bits stay, odd ones round up
    t = prec.round_to_tf32(torch.as_tensor(ties)).numpy().view(np.uint32)
    odd = (mant >> 13) & 1
    assert np.array_equal(t, np.where(odd == 1, (ties.view(np.uint32) + 0x1000),
                                      ties.view(np.uint32) - 0x1000).astype(np.uint32))


def _product(a, b, mode):
    A, B = torch.as_tensor(a), torch.as_tensor(b)
    if mode == "highest":
        return (A @ B).numpy()
    return (prec.split(A, -1, mode) @ prec.split_table(B, 0, mode)).numpy()


@pytest.mark.parametrize("K", [17, 300])
def test_products_within_bound_of_float64(K):
    rng = np.random.default_rng(K)
    a = (rng.standard_normal((40, K)) * rng.uniform(0.1, 10.0, (40, 1))).astype(np.float32)
    b = rng.standard_normal((K, 30)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    out = {m: _product(a, b, m) for m in MODE_BOUND}
    for mode, got in out.items():
        bound = (MODE_BOUND[mode] + TERMS[mode] * K * U) * mag
        assert got.dtype == np.float32
        assert (np.abs(got - exact) <= bound).all(), mode
    for mode in ("high", "default"):
        assert not np.array_equal(out[mode], out["highest"]), mode
    # "high" is far closer to exact than "default"
    err = {m: np.abs(out[m] - exact).max() for m in out}
    assert err["high"] < 0.01 * err["default"]


def test_split_layout_and_canonical_names():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * 1.001
    s = prec.split(x, 1, "HIGH")
    hi = prec.round_to_tf32(x)
    assert s.shape == (2, 9, 4)
    assert torch.equal(s[:, :3], hi) and torch.equal(s[:, 3:6], hi)
    assert torch.equal(s[:, 6:], prec.round_to_tf32(x - hi))
    assert torch.equal(prec.split(x, 1, "Default"), hi)
    t = prec.split_table(x, 0, "high")
    assert torch.equal(t[2:4], prec.round_to_tf32(x - hi)) and torch.equal(t[4:], hi)
    assert [prec.canonical(m) for m in ("HIGHEST", "High", "default")] == list(prec.MODES)
    for bad in ("fastest", "bf16", "tf32"):
        with pytest.raises(ValueError, match="precision"):
            prec.canonical(bad)
    with pytest.raises(ValueError, match="exact"):
        prec.split(x, 1, "highest")
    # TF32 is switched on nowhere on the CPU, and the switch is left alone
    before = torch.backends.cuda.matmul.allow_tf32
    with prec.tf32_products("cpu"):
        assert torch.backends.cuda.matmul.allow_tf32 == before
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _fields(T, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((4, T.nlat, T.nlon))
    shape = (4, T.num_fourier + 1, T.num_spherical + 1)
    s = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    s[..., 0, :] = s[..., 0, :].real
    return g, s * np.asarray(T.triangle)


@pytest.mark.parametrize("kw", [{}, dict(fourier_method="fft")], ids=["dft", "fft"])
def test_float64_ignores_the_mode(kw):
    T0 = ttr.make_transforms("T21", dtype=torch.float64, device="cpu", **kw)
    g, s = _fields(T0)
    ref = (ttr.grid_to_spec(T0, torch.as_tensor(g)), ttr.spec_to_grid(T0, torch.as_tensor(s)))
    for mode in ("high", "default"):
        T = ttr.make_transforms("T21", dtype=torch.float64, device="cpu", precision=mode, **kw)
        assert T.prec == mode and T.P_x is None and T.dft_ana_x is None
        assert torch.equal(ttr.grid_to_spec(T, torch.as_tensor(g)), ref[0])
        assert torch.equal(ttr.spec_to_grid(T, torch.as_tensor(s)), ref[1])


@pytest.mark.parametrize("res", ["T21", "T42"])
def test_transforms_match_isca_tpu_at_each_mode(res):
    g64, s64 = _fields(ttr.make_transforms(res, dtype=torch.float32, device="cpu"))
    g, s = g64.astype(np.float32), s64.astype(np.complex64)
    jax_out = {}
    for mode in prec.MODES:
        jT = jtr.make_transforms(res, dtype=jnp.float32, precision=mode)
        tT = ttr.make_transforms(res, dtype=torch.float32, device="cpu", precision=mode)
        ref = (np.asarray(jtr.grid_to_spec(jT, jnp.asarray(g))),
               np.asarray(jtr.spec_to_grid(jT, jnp.asarray(s))))
        got = (ttr.grid_to_spec(tT, torch.as_tensor(g)).numpy(),
               ttr.spec_to_grid(tT, torch.as_tensor(s)).numpy())
        jax_out[mode] = ref
        for name, a, b in zip(("grid_to_spec", "spec_to_grid"), got, ref):
            assert a.dtype == b.dtype
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= TRANSFORM_TOL[mode], (mode, name, err)
        if mode != "highest":
            assert not np.array_equal(got[0], jax_out["highest"][0])
    # isca_tpu's three modes are exact, bit-equal products on the CPU
    for mode in ("high", "default"):
        for a, b in zip(jax_out[mode], jax_out["highest"]):
            assert np.array_equal(a, b)


def test_mesh_branch_equals_one_device(tmp_path):
    spawn(cases.run, cases.NRANKS, "gloo", str(tmp_path / "init"), args=(str(tmp_path),),
          threads=1)
    for mode in cases.MODES:
        T = ttr.make_transforms("T21", dtype=torch.float32, device="cpu", precision=mode)
        g, s = cases.inputs(T)
        spec = ttr.grid_to_spec(T, torch.as_tensor(g)).numpy()
        grid = ttr.spec_to_grid(T, torch.as_tensor(s)).numpy()
        for r in range(cases.NRANKS):
            d = np.load(tmp_path / f"rank{r}.npz")
            m0, j0 = int(d[f"{mode}_m_start"]), int(d[f"{mode}_lat_start"])
            got_s, got_g = d[f"{mode}_spec"], d[f"{mode}_grid"]
            want_s = spec[:, m0:m0 + got_s.shape[1]]
            want_g = grid[:, j0:j0 + got_g.shape[1]]
            for a, b in ((got_s, want_s), (got_g, want_g)):
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), mode


SHAPE = dict(resolution="T21", num_levels=8, dt=1200.0)
HIGH_HS_FACTOR = 3.0 * 2.0 ** (24 - 22)


def _hs_jax(dtype, mode, steps):
    m = JHSM(JHSC(core=JPC(dtype=dtype, transform_precision=mode, **SHAPE)))
    s = jax.jit(lambda x: m.run(x, steps, first=True))(m.initial_state())
    return {k: np.asarray(v, np.float64) for k, v in m.diag_fields(s).items()}


def test_held_suarez_ten_steps_high_match_isca_tpu():
    ref32 = _hs_jax(jnp.float32, "high", 10)
    ref64 = _hs_jax(jnp.float64, "high", 10)
    tm = THSM(THSC(core=TPC(dtype=torch.float32, transform_precision="high", **SHAPE)),
              device="cpu")
    assert tm.core.T.prec == "high" and tm.core.T.P_x is not None
    ts = tm.run(tm.initial_state(), 10, first=True)
    got = {k: v.numpy().astype(np.float64) for k, v in tm.diag_fields(ts).items()}
    for k in ("ucomp", "vcomp", "temp", "ps", "vor", "div", "omega"):
        gap = float(np.abs(ref32[k] - ref64[k]).max())
        err = float(np.abs(got[k] - ref32[k]).max())
        assert np.isfinite(got[k]).all() and err <= HIGH_HS_FACTOR * gap, (k, err, gap)


def _every_model(mode):
    """Each model that takes transform_precision, small, on the CPU at
    `mode`: (name, model)."""
    from isca_tpu_torch.models.barotropic import BarotropicConfig, BarotropicModel
    from isca_tpu_torch.models.giant import giant_planet_model
    from isca_tpu_torch.models.moist import (GreyMoistModel, frierson_test_case_config,
                                             mima_test_case_config)
    from isca_tpu_torch.models.shallow import ShallowConfig, ShallowModel

    small = dict(resolution="T21", num_levels=8, transform_precision=mode)
    yield "held_suarez", THSM(THSC(core=TPC(dtype=torch.float32, dt=1200.0, **small)),
                              device="cpu")
    yield "barotropic", BarotropicModel(BarotropicConfig(
        resolution="T21", dtype=torch.float32, transform_precision=mode), device="cpu")
    yield "shallow", ShallowModel(ShallowConfig(
        resolution="T21", dtype=torch.float32, transform_precision=mode), device="cpu")
    yield "giant", giant_planet_model(resolution="T21", num_levels=8, transform_precision=mode,
                                      device="cpu")
    for name, build in (("frierson", frierson_test_case_config),
                        ("mima", mima_test_case_config)):
        cfg = build(dtype=torch.float32, transform_precision=mode)
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(cfg.core, resolution="T21"))
        yield name, GreyMoistModel(cfg, device="cpu")


@pytest.mark.parametrize("mode", ["high", "default"])
def test_every_model_takes_every_mode(mode):
    """PrimitiveConfig, BarotropicConfig, ShallowConfig, giant_planet_model
    and the moist configurations build at the mode, in float32, and all but
    MiMA (whose RRTM step costs seconds here; the card's `precision` phase
    steps it) take 2 finite steps."""
    for name, model in _every_model(mode):
        T = model.core.T if hasattr(model, "core") else model.T
        assert T.prec == mode and T.P_x is not None, name
        if name == "mima":
            continue
        state = model.run(model.initial_state(), 2)
        leaves = [x for x in (getattr(state, "tg", None), getattr(state, "vors", None),
                              getattr(getattr(state, "dyn", None), "tg", None)) if x is not None]
        assert leaves and all(bool(torch.isfinite(torch.view_as_real(x.curr) if x.curr.is_complex()
                                                  else x.curr).all()) for x in leaves), name
