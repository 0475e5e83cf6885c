"""Structural smoke of the port's realistic-continents gate
(isca_tpu_torch.climate_gate.gate_realistic), as
tests/test_climate_gate_smoke.py runs isca_tpu's: the real gate at a tiny
configuration (T21L8, grey radiation, a quarter-day orbit through
orbit_days_override, one spin-up orbit, so 240 spin-up steps and four
8-step windows) records every criterion with a finite value and the current
bounds stamp. The climate verdicts mean nothing at such an orbit and are not
asserted."""

import numpy as np
import pytest
import torch

from isca_tpu_torch import climate_gate as tg

GREY_KEYS = {
    "realistic_land_seasonal_amplitude",
    "realistic_continentality_ratio",
    "realistic_winter_jet_stronger",
    "realistic_tsurf_range_winter",
    "realistic_tsurf_range_summer",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager small-grid steps are many small ops: one intra-op thread runs
    them faster and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gate_realistic_grey_smoke():
    results = {}
    tg.gate_realistic(1, results, resolution="T21", levels=8, orbit_days_override=0.25,
                      radiation="grey", spin_orbits=1, device="cpu")
    assert GREY_KEYS <= set(results)
    assert "realistic_olr" not in results  # the OLR criterion is RRTM's
    for k in GREY_KEYS:
        rec = results[k]
        assert isinstance(rec["pass"], bool)
        assert rec["bounds_version"] == tg.bounds_version()
        assert np.isfinite(rec["value"])
