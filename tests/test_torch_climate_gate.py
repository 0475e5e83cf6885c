"""isca_tpu_torch.climate_gate against tools/climate_gate.py.

* The bounds registry and its hash are the JAX tool's.
* Every gate, fed the same seeded zonal means in both packages (the run
  replaced by a stand-in returning them, in this test only), records the
  same results dict: the same criteria, values, details and verdicts.
* Held-Suarez at T21 with the fewest steps the gate takes (256 spinup, 256
  averaged, --days 3) through both gates: the same criteria, each value
  within 1e-3 of the field's scale of isca_tpu's (float32 runs that round
  differently, over 512 steps of a laminar start) and the same verdicts.
* merge_artifacts' provenance, the artifact's bounds against the code's and
  the CLI's defaults (it never writes the JAX tool's artifacts).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from isca_tpu_torch import climate_gate as tg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import climate_gate as jg  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager small-grid steps are many small ops: one intra-op thread runs
    them faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bounds_registry_is_the_jax_tools():
    assert tg.BOUNDS == jg.BOUNDS
    assert tg.bounds_version() == jg.bounds_version() == "48ec10b2d051"
    # the hash both committed artifacts of the JAX tool carry
    for path in ("CLIMATE_GATE.json", "PRECISION_GATE.json"):
        art = json.load(open(os.path.join(tg.ROOT, path)))
        assert art["bounds_version"] == art["bounds_version_code"] == tg.bounds_version()


def _seeded(shapes, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale[k][1] + scale[k][0]) for k, s in shapes.items()}


def _stand_in_means(shapes, scale, total_steps=None):
    """A stand-in for the gate's run that returns seeded zonal means (the
    same for both packages) instead of integrating."""
    def fake(model, state, *args, **kwargs):
        zm = _seeded(shapes, 11, scale)
        return (state, zm) if total_steps is None else (state, zm, total_steps)
    return fake


def _both(monkeypatch, attr, fake, call):
    """call(gate module, results, keyword arguments) in both packages, the
    port's models built on the CPU."""
    out = []
    for mod in (jg, tg):
        monkeypatch.setattr(mod, attr, fake)
        results = {}
        call(mod, results, {"device": "cpu"} if mod is tg else {})
        out.append(results)
    return out


def test_gates_record_the_same_results_on_the_same_means(monkeypatch):
    L, nlat = 25, 32
    hs_scale = {"u": (5.0, 12.0), "t": (250.0, 25.0)}
    jr, tr_ = _both(monkeypatch, "zonal_time_mean",
                    _stand_in_means({"u": (L, nlat), "t": (L, nlat)}, hs_scale),
                    lambda m, r, kw: m.gate_held_suarez(3, r, resolution="T21", **kw))
    assert jr == tr_ and len(tr_) == 8

    fr_scale = {"u": (8.0, 10.0), "ts": (290.0, 10.0), "q": (0.01, 0.004)}
    jr, tr_ = _both(monkeypatch, "zonal_time_mean",
                    _stand_in_means({"u": (25, 64), "ts": (64,), "q": (25, 64)}, fr_scale),
                    lambda m, r, kw: m.gate_frierson(100, r, **kw))
    assert jr == tr_ and len(tr_) == 6

    gp_scale = {"u": (0.0, 10.0), "t": (150.0, 10.0)}
    jr, tr_ = _both(monkeypatch, "_chained_spin_and_average",
                    _stand_in_means({"u": (30, nlat), "t": (30, nlat)}, gp_scale, 3000 * 48),
                    lambda m, r, kw: m.gate_giant(40, r, resolution="T21", **kw))
    assert jr == tr_ and len(tr_) == 4


def test_mima_gate_records_the_same_results_on_the_same_means(monkeypatch):
    mm_scale = {"u": (10.0, 12.0), "t": (230.0, 30.0), "ts": (290.0, 10.0),
                "q": (0.01, 0.004)}
    shapes = {"u": (40, 64), "t": (40, 64), "ts": (64,), "q": (40, 64)}
    # isca_tpu's gate reads the reference's ozone file where it exists; the
    # port's has only the constant fallback
    real_exists = os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda p: False if "ozone" in str(p)
                        else real_exists(p))
    jr, tr_ = _both(monkeypatch, "_chained_spin_and_average",
                    _stand_in_means(shapes, mm_scale, 150 * 144),
                    lambda m, r, kw: m.gate_mima(100, r, **kw))
    assert jr == tr_ and len(tr_) == 7


def test_held_suarez_fewest_steps_through_both_gates():
    jr, tr_ = {}, {}
    jg.gate_held_suarez(3, jr, resolution="T21")
    tg.gate_held_suarez(3, tr_, resolution="T21", device="cpu")
    assert set(jr) == set(tr_) and len(tr_) == 8
    scale = {"hs_jet_strength": 10.0, "hs_jet_latitude": 90.0, "hs_jet_height": 1.0,
             "hs_tropical_easterlies": 10.0, "hs_surface_westerlies": 10.0,
             "hs_trade_easterlies": 10.0, "hs_tropopause_temp": 300.0,
             "hs_meridional_contrast": 60.0}
    for k, rec in tr_.items():
        assert rec["bounds_version"] == jr[k]["bounds_version"] == tg.bounds_version()
        assert rec["bounds"] == jr[k]["bounds"]
        assert abs(rec["value"] - jr[k]["value"]) <= 1e-3 * scale[k], (k, rec, jr[k])
        assert rec["pass"] == jr[k]["pass"], (k, rec, jr[k])


def test_merge_keeps_provenance_and_card(tmp_path):
    run = lambda prec_, crit, ok: {
        "criteria": {crit: {"pass": ok, "bounds_version": tg.bounds_version()}},
        "configs_run": ["hs"], "wall_seconds": 1500.0, "date": "d",
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W", "days_arg": 1200,
        "precision": prec_, "transform_precision": {"hs": prec_}}
    a, b, out = tmp_path / "high.json", tmp_path / "highest.json", tmp_path / "m.json"
    a.write_text(json.dumps(run("high", "x", True)))
    b.write_text(json.dumps(run("highest", "y", False)))
    assert tg.merge_artifacts([str(a), str(b)], str(out)) == 1
    m = json.loads(out.read_text())
    assert [r["precision"] for r in m["runs"]] == ["high", "highest"]
    assert [list(r["criteria"]) for r in m["runs"]] == [["x"], ["y"]]
    assert all(r["nvidia_smi"] == "NVIDIA H100 80GB HBM3, 700.00 W" for r in m["runs"])
    assert m["nvidia_smi"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert m["passed"] == 1 and m["total"] == 2 and m["wall_seconds"] == 3000.0
    assert m["bounds_version"] == m["bounds_version_code"] == tg.bounds_version()
    # re-merging a merged artifact carries its rows through
    assert tg.merge_artifacts([str(out)], str(tmp_path / "again.json")) == 1
    assert len(json.loads((tmp_path / "again.json").read_text())["runs"]) == 2


def test_artifact_bounds_match_code():
    """The port's committed artifact (CLIMATE_GATE_TORCH.json) was judged
    under the code's bounds, criterion by criterion."""
    path = os.path.join(tg.ROOT, tg.DEFAULT_JSON)
    assert os.path.exists(path), "CLIMATE_GATE_TORCH.json is the port's gate record"
    art = json.load(open(path))
    assert art["bounds_version_code"] == tg.bounds_version()
    assert art["platform"] == "gpu" and art["nvidia_smi"]
    for name, rec in art["criteria"].items():
        assert rec["bounds_version"] == tg.bounds_version(), name
        if name in tg.BOUNDS and "bounds" in rec:
            want = tg.BOUNDS[name]
            assert (rec["bounds"] == want if isinstance(want, dict)
                    else list(rec["bounds"]) == list(want)), name


def test_cli_never_writes_the_jax_artifacts(tmp_path):
    assert tg.DEFAULT_JSON == "CLIMATE_GATE_TORCH.json"
    for name in ("CLIMATE_GATE.json", "PRECISION_GATE.json"):
        with pytest.raises(SystemExit, match="JAX tool"):
            tg.main(["--only", "hs", "--json", name, "--device", "cpu"])
        with pytest.raises(SystemExit, match="JAX tool"):
            tg.main(["--merge", str(tmp_path / "x.json"), "--json", name])
