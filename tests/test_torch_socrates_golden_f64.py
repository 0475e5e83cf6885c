"""isca_tpu_torch's SOCRATES aquaplanet over the socrates_aquaplanet golden's
horizon with float64 SOCRATES on both sides.

tools/trip_test.py build_socrates_aquaplanet (T21L8 float64, 2 model days),
with a float64 `SocratesRadiation` set as the physics' radiation in both
packages (no isca_tpu file changes). Every statistic trip_test keeps (mean,
std, min, max, four probes) of every field lies within F64_TOL = 1e-7 of
the field's scale (the largest |min|, |max|) from isca_tpu's: measured here
1.9e-8, what ROADMAP C.5 (XLA's float32 arcsin in the seasonal declination)
leaves. So where both packages round alike the port follows the reference
over the golden's horizon; the golden itself records float32 SOCRATES
(tests/test_torch_socrates_golden.py, ROADMAP C.8).
"""

from tests.test_torch_socrates_golden import distance, jax_stats, port_stats
from tests.test_torch_socrates_golden import one_torch_thread  # noqa: F401 (autouse)

F64_TOL = 1e-7


def test_socrates_aquaplanet_float64_follows_isca_tpu():
    j64, t64 = jax_stats(True), port_stats(True)
    worst = distance(t64, j64)
    assert max(worst.values()) <= F64_TOL, worst
