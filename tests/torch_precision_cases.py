"""What the ranks of tests/test_torch_precision.py's sharded case run: the
T21 float32 transforms at "high" and "default" on a mesh of gloo ranks on
the CPU. A module apart from the test file, so that the spawned ranks import
no JAX (the test file does)."""

import numpy as np
import torch

from isca_tpu_torch.parallel.mesh import make_mesh
from isca_tpu_torch.spectral import transforms as ttr

NRANKS = 2
MODES = ("high", "default")
SEED = 5


def inputs(T):
    """Seeded global grid (3, nlat, nlon) and spectral (3, M+1, N+1) fields."""
    rng = np.random.default_rng(SEED)
    g = rng.standard_normal((3, T.nlat, T.nlon)).astype(np.float32)
    shape = (3, T.num_fourier + 1, T.num_spherical + 1)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    s[..., 0, :] = s[..., 0, :].real
    return g, s * T.triangle.cpu().numpy()


def run(rank, out):
    """Each mode's analysis of this rank's band (its m block of spectra) and
    synthesis of its m block (its band of grid), saved per rank."""
    mesh = make_mesh(NRANKS, device="cpu")
    res = {}
    for mode in MODES:
        T1 = ttr.make_transforms("T21", dtype=torch.float32, device="cpu", precision=mode)
        T = ttr.make_transforms("T21", dtype=torch.float32, mesh=mesh, precision=mode)
        g, s = inputs(T1)
        res[f"{mode}_spec"] = ttr.grid_to_spec(T, torch.as_tensor(T.local_lat(g, 1))).numpy()
        res[f"{mode}_grid"] = ttr.spec_to_grid(T, torch.as_tensor(T.local_m(s, 1))).numpy()
        res[f"{mode}_m_start"] = T.m_start
        res[f"{mode}_lat_start"] = T.lat_start
    np.savez(f"{out}/rank{rank}.npz", **res)
