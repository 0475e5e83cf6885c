"""The socrates_aquaplanet trip golden and isca_tpu_torch.

tools/trip_test.py build_socrates_aquaplanet (T21L8 float64, SOCRATES
radiation, 2 model days) against tests/goldens/trip_goldens.json, with
trip_test's own compare (RTOL 1e-7). The golden records the rounding of
SOCRATES in float32, the dtype isca_tpu's driver builds it in inside the
float64 model (ROADMAP C.8), and that rounding decides it:

* isca_tpu as the driver builds it meets the golden;
* isca_tpu with float64 SOCRATES set as the physics' radiation (no isca_tpu
  file changes) misses it, as does the port with its float32 SOCRATES,
  whose float32 exp, log and pow round other than XLA's;
* the port's float32 run lies from isca_tpu's within MISS_FACTOR = 8 times
  isca_tpu's own float32-versus-float64 distance, field by field, each
  distance the largest difference of a statistic over the field's scale
  (the largest |min|, |max|; measured here: 5.7 in div, under 3 elsewhere);
* the port with float64 SOCRATES follows isca_tpu with float64 SOCRATES
  (tests/test_torch_socrates_golden_f64.py).

No golden and no compare tolerance is changed for this.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from isca_tpu.physics import socrates as js
from isca_tpu_torch.models import moist as tmoist
from isca_tpu_torch.physics import moist_driver as tmd
from isca_tpu_torch.physics import socrates as ts

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_moist import TRIP_CORE  # noqa: E402
from tools import trip_test  # noqa: E402

MISS_FACTOR = 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def steps():
    return int(round(trip_test.DAYS * 86400.0 / TRIP_CORE["dt"]))


def jax_stats(f64):
    model = trip_test.build_socrates_aquaplanet()
    if f64:
        model.physics.radiation = js.SocratesRadiation(js.SocratesConfig(), dtype=jnp.float64)
    state = jax.jit(lambda s: model.run(s, steps(), first=True))(model.initial_state())
    return {k: trip_test.field_stats(v) for k, v in sorted(model.diag_fields(state).items())}


def port_stats(f64):
    cfg = tmoist.GreyMoistConfig(
        core=tmoist.PrimitiveConfig(dtype=torch.float64, **TRIP_CORE),
        physics=tmd.MoistPhysicsConfig(radiation_scheme="socrates",
                                       socrates=ts.SocratesConfig()))
    model = tmoist.GreyMoistModel(cfg, device="cpu")
    if f64:
        model.physics.radiation = ts.SocratesRadiation(ts.SocratesConfig(),
                                                       dtype=torch.float64, device="cpu")
    state = model.run(model.initial_state(), steps())
    return {k: trip_test.field_stats(v.numpy()) for k, v in sorted(model.diag_fields(state).items())}


def distance(a, b):
    """Per field: the largest difference of any statistic, over the
    field's scale."""
    out = {}
    for f, g in b.items():
        d = [abs(a[f][k] - g[k]) for k in ("mean", "std", "min", "max")]
        d += [abs(x - y) for x, y in zip(a[f]["probes"], g["probes"])]
        out[f] = max(d) / max(abs(g["max"]), abs(g["min"]))
    return out


def test_socrates_aquaplanet_golden_and_float32_rounding():
    golden = json.loads((REPO / "tests" / "goldens" / "trip_goldens.json").read_text())
    golden = golden["socrates_aquaplanet"]
    j32, j64, t32 = jax_stats(False), jax_stats(True), port_stats(False)
    assert trip_test.compare("socrates_aquaplanet", j32, golden) == []
    assert trip_test.compare("socrates_aquaplanet", j64, golden) != []
    gap, miss = distance(j64, j32), distance(t32, j32)
    for f in golden:
        assert miss[f] <= MISS_FACTOR * gap[f], (f, miss[f], gap[f])
