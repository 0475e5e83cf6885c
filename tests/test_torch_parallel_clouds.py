"""The cloud GCMs on the port's mesh: simple_clouds_test_case_config()
(SimCloud feeding both RRTMG cloud optics, so that sw_flux runs clear, then
cloudy, on each rank's band) and the SOCRATES aquaplanet with clouds
(float64 SOCRATES on both sides, ROADMAP C.8), both from a moist start
(0.01 kg/kg) so that the clouds are there, sharded over 4 gloo ranks on the
CPU at T21L8 float64, 3 steps: against isca_tpu's single-device runs at
3x their measured gap (SEASONAL_RTOL; ROADMAP C.5: both take the seasonal
declination) and the port's own at rtol 1e-9, each rank's m block distinct. The machinery is
tests/test_torch_parallel_gcm.py's.
"""

import pytest

import torch_sharded_cases as cases
from tests.test_torch_gcm_ras import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_parallel_gcm import (
    check_isca_tpu, check_m_blocks, check_single, join, ranks_fixture, references_of, stop)

pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")
WHICH = "clouds"
SPECTRAL = tuple(n for n in cases.GCM_FILES[WHICH] if n != "column")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx, out = ranks_fixture(WHICH, tmp_path_factory)
    yield ctx, out
    stop(ctx)


@pytest.fixture(scope="module")
def references(ranks):
    return references_of(WHICH)


@pytest.fixture(scope="module")
def sharded(ranks, references):
    return join(*ranks)


@pytest.mark.parametrize("name", cases.GCM_FILES[WHICH])
def test_sharded_gcm_matches_isca_tpu_single_device(sharded, references, name):
    check_isca_tpu(sharded, references, name)


@pytest.mark.parametrize("name", cases.GCM_FILES[WHICH])
def test_sharded_gcm_matches_port_single_device(sharded, references, name):
    check_single(sharded, references, name)


@pytest.mark.parametrize("name", SPECTRAL)
def test_sharded_gcm_m_blocks_distinct(sharded, name):
    check_m_blocks(sharded, name)
