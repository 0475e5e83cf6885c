"""The other models on the port's mesh, sharded over 4 gloo ranks on
the CPU at float64, 3 steps: the realistic continents with their
topography and the bucket (set_land takes the whole globe's fields, each
rank keeps its band; the topography is band-limited with mesh-less
transforms), continents_sst with its seeded SST and sea-ice series and the
orographic drag's hprime, the giant planet (T21L8), the stirred
shallow-water model (resolution 31: its 32 m rows need no padding, so the
stirring draws the shape isca_tpu's one device draws) and the column model
(8 x 4 seeded columns, RRTMG-SW with grey LW: each rank runs sw_flux on its
2 rows). Against isca_tpu's single-device runs and the port's own at
rtol 1e-9 of each leaf's largest entry, each rank's m block distinct. The
machinery is tests/test_torch_parallel_gcm.py's.
"""

import pytest

import torch_sharded_cases as cases
from tests.test_torch_gcm_ras import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_parallel_gcm import (
    check_isca_tpu, check_m_blocks, check_single, join, ranks_fixture, references_of, stop)

pytestmark = pytest.mark.filterwarnings("ignore:RRTMG-LW is running on SYNTHETIC")
WHICH = "models"
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
