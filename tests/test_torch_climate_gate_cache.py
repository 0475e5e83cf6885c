"""The port's climate-gate state cache against isca_tpu's
(tools/climate_gate.py): the same npz layout, so a chain moves between the
packages in both directions, bit for bit.

* A giant-planet (grey moist, T21L6) and a Held-Suarez (T21L8) state written
  by isca_tpu are read by the port, and the port's are read by isca_tpu,
  every leaf bit-equal, the counters and float64 accumulators intact.
* A fingerprint or leaf-count mismatch is refused.
* A chained run (a wall-budget stop after the first chunk, then a resume)
  equals the uninterrupted zonal_time_mean over the same steps, state and
  means bit for bit (the Held-Suarez gate runs either way).
* The committed caches under exp/gate_cache/ are read-only: checkpoints go
  under .gate_cache/. The committed giant chain's fingerprint is the one the
  port's gate asks for at T213 "high", and the committed MiMA chain resumes
  in the port's MiMA model.
"""

import json
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu.dycore.primitive import PrimitiveConfig as JPC
from isca_tpu.models.dry import HeldSuarezConfig as JHSC
from isca_tpu.models.dry import HeldSuarezModel as JHSM
from isca_tpu.models.giant import giant_planet_model as jgiant
from isca_tpu_torch import climate_gate as tg
from isca_tpu_torch.dycore.primitive import PrimitiveConfig as TPC
from isca_tpu_torch.models.dry import HeldSuarezConfig as THSC
from isca_tpu_torch.models.dry import HeldSuarezModel as THSM
from isca_tpu_torch.models.giant import giant_planet_model as tgiant

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import climate_gate as jg  # noqa: E402

FP = {"config": "test", "resolution": "T21", "num_levels": 6, "dt": 1800.0}
HS = dict(resolution="T21", num_levels=8, dt=1200.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager small-grid steps are many small ops: one intra-op thread runs
    them faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _models(kind):
    if kind == "giant":
        return (jgiant(resolution="T21", num_levels=6),
                tgiant(resolution="T21", num_levels=6, device="cpu"))
    return (JHSM(JHSC(core=JPC(dtype=jnp.float32, **HS))),
            THSM(THSC(core=TPC(dtype=torch.float32, **HS)), device="cpu"))


@pytest.mark.parametrize("kind", ["giant", "held_suarez"])
def test_caches_move_between_the_packages(kind, tmp_path):
    jm, tm = _models(kind)
    js = jax.jit(lambda x: jm.run(x, 4, first=True))(jm.initial_state())
    acc = {"u": np.arange(12, dtype=np.float64).reshape(3, 4) * 1.7}
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jg._save_state_cache(j_path, js, 7 * 48 + 3, FP, avg_steps=256, accum=acc)

    ts, steps, avg_steps, acc_r = tg._load_state_cache(j_path, tm.initial_state(), FP)
    assert (steps, avg_steps) == (7 * 48 + 3, 256)
    assert set(acc_r) == {"u"} and _bits_equal(acc_r["u"], acc["u"])
    jl = _jax_leaves(js)
    tl = tg.state_to_leaves(ts)
    assert len(tl) == len(jl) == len(tg.state_leaf_keys(ts))
    for i, (a, b) in enumerate(zip(tl, jl)):
        b = np.stack([b.real, b.imag]) if np.iscomplexobj(b) else b
        assert _bits_equal(a, b), (i, tg.state_leaf_keys(ts)[i])

    # and back: the port's cache read by isca_tpu
    tg._save_state_cache(t_path, ts, steps, FP, avg_steps, {"u": torch.as_tensor(acc["u"])})
    js2, steps2, avg2, acc2 = jg._load_state_cache(t_path, jm.initial_state(), FP)
    assert (steps2, avg2) == (steps, avg_steps) and _bits_equal(acc2["u"], acc["u"])
    for i, (a, b) in enumerate(zip(_jax_leaves(js2), jl)):
        assert _bits_equal(a, b), i
    with np.load(t_path) as d, np.load(j_path) as e:
        assert sorted(d.files) == sorted(e.files)


def test_mismatches_are_refused(tmp_path):
    _, tm = _models("giant")
    path = str(tmp_path / "fp.npz")
    tg._save_state_cache(path, tm.initial_state(), 10, FP)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tg._load_state_cache(path, tm.initial_state(), dict(FP, resolution="T42"))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tg._load_state_cache(path, tm.initial_state(), dict(FP, transform_precision="high"))
    _, hs = _models("held_suarez")
    with pytest.raises(ValueError, match="leaves"):
        tg._load_state_cache(path, hs.initial_state(), FP)


def test_chained_run_matches_uninterrupted(tmp_path):
    _, tm = _models("held_suarez")
    path = str(tmp_path / "chain.npz")
    fp = {"config": "held_suarez", "resolution": "T21", "num_levels": 8, "dt": 1200.0}
    fields = lambda st: {"u": st.ug.curr.mean(dim=-1), "t": st.tg.curr.mean(dim=-1)}
    spin, avg = 256, 256   # one chunk each
    with pytest.raises(tg.WallBudget):
        tg._chained_spin_and_average(tm, tm.initial_state(), fields, spin, avg, cache=path,
                                     fingerprint=fp, deadline=time.time() - 1.0)
    with np.load(path) as d:
        assert int(d["steps"]) == 256 and int(d["avg_steps"]) == 0
    s_chained, zm_chained, n_chained = tg._chained_spin_and_average(
        tm, tm.initial_state(), fields, spin, avg, cache=path, fingerprint=fp)
    s_direct, zm_direct = tg.zonal_time_mean(tm, tm.initial_state(), spin, avg, fields)
    assert n_chained == spin + avg
    for a, b in zip(tg.state_to_leaves(s_chained), tg.state_to_leaves(s_direct)):
        assert _bits_equal(a, b)
    for k in ("u", "t"):
        assert zm_chained[k].dtype == np.float64 and _bits_equal(zm_chained[k], zm_direct[k])
    # the 1200-day Held-Suarez gate's spin-up and average are whole chunks,
    # so its chained and direct runs take the same steps
    spd = 86400 // 600
    assert (1200 // 3) * spd % tg.CH == 0 and (1200 - 1200 // 3) * spd % tg.CH == 0


def test_committed_caches_are_read_only(tmp_path):
    committed = os.path.join(tg.COMMITTED_CACHES, "giant_T213.npz")
    assert tg._checkpoint_path(committed) == os.path.join(tg.WRITABLE_CACHES, "giant_T213.npz")
    other = str(tmp_path / "x.npz")
    assert tg._checkpoint_path(other) == other
    _, tm = _models("held_suarez")
    with pytest.raises(ValueError, match="read-only"):
        tg._save_state_cache(os.path.join(tg.COMMITTED_CACHES, "new.npz"),
                             tm.initial_state(), 1, FP)
    assert not os.path.exists(os.path.join(tg.COMMITTED_CACHES, "new.npz"))
    # the committed T213 chain was integrated at "high": the port's gate asks
    # for the same fingerprint, so it resumes that chain
    with np.load(committed) as d:
        saved = json.loads(bytes(d["fingerprint"]).decode())
    model = types.SimpleNamespace(core=types.SimpleNamespace(
        config=types.SimpleNamespace(dt=1800.0)))
    assert tg.giant_fingerprint(model, "T213", 100, "high") == saved


def test_committed_mima_chain_resumes_in_the_port():
    # the committed MiMA chain (isca_tpu's, T42L40) is what the port's MiMA
    # gate asks for: same fingerprint, same leaves, read without a write
    committed = os.path.join(tg.COMMITTED_CACHES, "mima_T42.npz")
    before = os.path.getmtime(committed)
    model = tg.mima_model(None, device="cpu")
    state, steps, avg_steps, accum = tg._load_state_cache(
        committed, model.initial_state(), tg.mima_fingerprint(model))
    assert (steps, avg_steps, accum) == (256, 0, None)
    with np.load(committed) as d:
        for i, leaf in enumerate(tg.state_to_leaves(state)):
            assert _bits_equal(leaf, d[f"leaf{i}"]), i
    assert bool(torch.isfinite(state.dyn.tg.curr).all())
    assert os.path.getmtime(committed) == before
