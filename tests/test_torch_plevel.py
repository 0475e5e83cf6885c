"""The port's pressure-level interpolation (isca_tpu_torch/io/plevel.py)
against isca_tpu's, bit for bit: on tests/test_tools.py's synthetic diag
file (T linear in sigma, ps in hPa) and on a daily diag file written by the
port's Experiment (Held-Suarez T21L8 float64, one day, temp and ps
averaged: ps in Pa, masked and extrapolated), every variable and
attribute of the output file equal."""

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from isca_tpu.io import plevel as jplevel
from isca_tpu_torch.io import plevel as tplevel


def read_nc(path):
    with netcdf_file(str(path), "r", mmap=False) as nc:
        return ({k: v for k, v in nc.dimensions.items()},
                {k: (v.dimensions, np.array(v[:]), dict(v._attributes))
                 for k, v in nc.variables.items()})


def assert_same_output(infile, tmp_path, **kw):
    """Both packages' run_plevel on infile: identical files."""
    a, b = tmp_path / "port_plev.nc", tmp_path / "jax_plev.nc"
    tplevel.run_plevel(infile, a, **kw)
    jplevel.run_plevel(infile, b, **kw)
    dims_a, vars_a = read_nc(a)
    dims_b, vars_b = read_nc(b)
    assert dims_a == dims_b and list(vars_a) == list(vars_b)
    for k, (d, arr, attrs) in vars_b.items():
        assert vars_a[k][0] == d and vars_a[k][2] == attrs, k
        assert vars_a[k][1].dtype == arr.dtype, k
        np.testing.assert_array_equal(vars_a[k][1], arr, err_msg=k)
    return vars_a


def test_defaults_and_interp_equal_isca_tpu():
    np.testing.assert_array_equal(tplevel.DEFAULT_PLEVS, jplevel.DEFAULT_PLEVS)
    rng = np.random.default_rng(3)
    p = np.sort(rng.uniform(50.0, 1.0e5, (4, 6, 9)), axis=-1)
    f = rng.standard_normal((4, 6, 9))
    for extrapolate in (False, True):
        a = tplevel.interp_to_plevels(f, p, tplevel.DEFAULT_PLEVS, extrapolate=extrapolate)
        b = jplevel.interp_to_plevels(f, p, jplevel.DEFAULT_PLEVS, extrapolate=extrapolate)
        np.testing.assert_array_equal(a, b)


def test_synthetic_file_bit_equal(tmp_path):
    """tests/test_tools.py's case: T(p) = 200 + 60 sigma, ps 1000 hPa."""
    nt, L, nlat, nlon = 2, 10, 4, 8
    sig = np.linspace(0.05, 0.95, L)
    infile = tmp_path / "atmos.nc"
    with netcdf_file(str(infile), "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("pfull", L)
        nc.createDimension("lat", nlat)
        nc.createDimension("lon", nlon)
        nc.createVariable("time", "d", ("time",))[:] = [1.0, 2.0]
        nc.createVariable("pfull", "d", ("pfull",))[:] = sig * 1000.0
        nc.createVariable("lat", "d", ("lat",))[:] = np.linspace(-60, 60, nlat)
        nc.createVariable("lon", "d", ("lon",))[:] = np.linspace(0, 315, nlon)
        t = nc.createVariable("temp", "f", ("time", "pfull", "lat", "lon"))
        t[:] = (200.0 + 60.0 * sig)[None, :, None, None] * np.ones((nt, L, nlat, nlon))
        ps = nc.createVariable("ps", "f", ("time", "lat", "lon"))
        ps[:] = np.full((nt, nlat, nlon), 1000.0)   # hPa
    out = assert_same_output(infile, tmp_path, plevs=np.array([2.0e4, 5.0e4, 8.0e4]))
    temp = out["temp"][1]
    assert temp.shape == (2, 3, nlat, nlon)
    # linear in sigma -> value at p = 0.5 ps is ~230 K (test_tools.py's check)
    np.testing.assert_allclose(temp[0, 1, 0, 0], 200 + 60 * 0.5, rtol=0.02)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_experiment_diag_file_bit_equal(tmp_path, extrapolate):
    """A daily file of the port's Experiment: HS T21L8 float64, one day,
    temp and ps averaged (ps in Pa), ucomp instantaneous."""
    from isca_tpu_torch.dycore.primitive import PrimitiveConfig
    from isca_tpu_torch.experiment import Experiment
    from isca_tpu_torch.io.diag_manager import DiagTable
    from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel

    model = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(
        resolution="T21", num_levels=8, dt=1800.0, dtype=torch.float64)), device="cpu")
    table = DiagTable().add_file("atmos_daily", 86400)
    for field, avg in (("temp", True), ("ps", True), ("ucomp", False)):
        table.add_field("atmos_daily", "dynamics", field, time_avg=avg)
    exp = Experiment("plev", model, table, datadir=str(tmp_path))
    exp.run(1, days=1)
    infile = tmp_path / "plev" / "run0001" / "atmos_daily.nc"
    out = assert_same_output(infile, tmp_path, extrapolate=extrapolate)
    temp = out["temp"][1]
    assert temp.shape[:2] == (1, tplevel.DEFAULT_PLEVS.size)
    assert np.isnan(temp).any() != extrapolate      # 1 Pa lies above the model top
    assert np.isfinite(out["ucomp"][1]).any() and "ps" in out
