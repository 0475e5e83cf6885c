"""Spherical-harmonic transforms and spectral operators.

Port of isca_tpu/spectral/transforms.py, single-device path (reference:
`src/atmos_spectral/tools/transforms.F90`, `spherical_fourier.F90`,
`spherical.F90`, `grid_fourier.F90`, `src/shared/fft/`).

* The Legendre analysis/synthesis are dense contractions over precomputed
  Pbar / Pbar*w tables, and the longitude Fourier stage is a dense real-DFT
  matrix product (or `torch.fft.rfft` with fourier_method="fft"): batched
  matrix products. Their precision is the transforms' `precision`
  (isca_tpu's transform_precision, spectral/precision.py): "highest" is
  exact FP32 on cuBLAS (TF32 is off, isca_tpu_torch/__init__.py); "high"
  (3xTF32) and "default" (one TF32 pass) run on the card as one launch of
  the tf32_product kernel a product, which splits the data operand as it
  loads it, against constant tables split and packed once, here; float64
  and the FFT ignore the mode.
* Complex values never meet a complex matrix product: the tables are real,
  so each contraction runs on the split real/imaginary parts (a complex
  cuBLAS product sums in another order), as isca_tpu does.
* Spectral storage is a dense complex tensor indexed [..., m, n] with
  m = 0..M (num_fourier) and *total* wavenumber n = 0..N+1 (num_spherical).
  Entries with n < m are structurally zero. The extra n = N+1 row exists, as
  in the reference, so that wind synthesis from (vor, div) is exact.

The two stages run inside profiler ranges named "dft" and "legendre" (as
isca_tpu's named scopes), so a torch.profiler trace gives each its device time.

Normalization: see isca_tpu_torch.spectral.gauss. Global area mean of a field
equals the real part of its (m=0, n=0) coefficient.

On a mesh (isca_tpu_torch.parallel.mesh; isca_tpu's shard_map branch,
reference: the transpose of transforms.F90:970-1056 and spec_mpp.F90) each
rank holds its latitude band of the grid-space tables and its block of m
rows of the spectral ones, so grid tensors are (..., lat_band, lon) and
spectral tensors (..., m_block, n). A transform is a local DFT, one
`all_to_all` of the real (re, im) Fourier coefficients between the two
layouts, and a local Legendre product (the reverse for synthesis); with
overlap_chunks > 1 the leading batch axis runs as that many chains whose
transposes overlap the previous chain's Legendre product. Global means are
an `all_reduce`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from isca_tpu_torch import resolve_device
from isca_tpu_torch.parallel.mesh import check_mesh
from isca_tpu_torch.spectral import gauss, precision as _precision

# Standard triangular truncations -> (nlon, nlat), as in the reference's RESOLUTIONS
# table (src/extra/python/isca/experiment.py:29-56).
RESOLUTIONS: dict[str, tuple[int, int, int]] = {
    "T21": (21, 64, 32),
    "T42": (42, 128, 64),
    "T85": (85, 256, 128),
    "T170": (170, 512, 256),
    "T213": (213, 640, 320),
}


@dataclasses.dataclass(frozen=True)
class SphericalTransforms:
    """Precomputed transform tables for one resolution, as tensors on one
    device. On a mesh, the (nlat,)-indexed tables hold this rank's latitude
    band and the m-indexed ones its block of m rows (nlat, num_fourier and
    num_fourier_true stay global); the DFT tables are whole."""

    truncation: int       # T (e.g. 42)
    num_fourier: int      # m rows - 1 (>= true M when the m axis is padded)
    num_fourier_true: int # true M: largest retained zonal-wavenumber index
    num_spherical: int    # N+1 rows of total wavenumber retained for winds
    nlon: int
    nlat: int
    radius: float

    wts: torch.Tensor        # (nlat,) Gaussian weights, sum = 2
    sinlat: torch.Tensor     # (nlat,) mu, ascending (south -> north)
    coslat: torch.Tensor     # (nlat,)
    lats: torch.Tensor       # (nlat,) radians
    lons: torch.Tensor       # (nlon,) radians
    P: torch.Tensor          # (nlat, M+1, N+2) Pbar_n^m(mu_j)
    Pw: torch.Tensor         # (nlat, M+1, N+2) Pbar * w_j / 2 (analysis table)
    eps: torch.Tensor        # (M+1, N+3) recurrence coefficients
    mvec: torch.Tensor       # (M+1,) float m
    nn1: torch.Tensor        # (N+2,) float n(n+1)
    inv_nn1: torch.Tensor    # (N+2,) 1/(n(n+1)), 0 at n=0
    triangle: torch.Tensor   # (M+1, N+2) mask: 1 where m <= n <= T (prognostic triangle)
    eigenvalues: torch.Tensor  # (N+2,) -n(n+1)/a^2 (Laplacian eigenvalues)
    # operator coefficient tables (host-built, see make_transforms):
    uv_im: torch.Tensor      # (M+1, N+2)  m/(n(n+1)) for wind synthesis (times -i)
    uv_cm: torch.Tensor      # (M+1, N+2) -eps(m,n)/n            (times x_{n-1})
    uv_cp: torch.Tensor      # (M+1, N+2)  eps(m,n+1)/(n+1)      (times x_{n+1})
    vd_im: torch.Tensor      # (M+1, N+2)  m                     (times i)
    vd_dn: torch.Tensor      # (M+1, N+2)  n*eps(m,n+1)          (times x_{n+1})
    vd_up: torch.Tensor      # (M+1, N+2)  (n+1)*eps(m,n)        (times x_{n-1})
    cdl_up: torch.Tensor     # (M+1, N+2) -(n-1)*eps(m,n)        (times x_{n-1})
    cdl_dn: torch.Tensor     # (M+1, N+2)  (n+2)*eps(m,n+1)      (times x_{n+1})
    inv_eig: torch.Tensor    # (N+2,) -a^2/(n(n+1)), 0 at n=0 (inverse Laplacian)
    # real DFT tables
    dft_cos_f: torch.Tensor  # (nlon, M+1) cos(m lam)/nlon   (analysis, real part)
    dft_sin_f: torch.Tensor  # (nlon, M+1) -sin(m lam)/nlon  (analysis, imag part)
    dft_cos_i: torch.Tensor  # (M+1, nlon) w_m cos(m lam)    (synthesis; w_0=1 else 2)
    dft_sin_i: torch.Tensor  # (M+1, nlon) -w_m sin(m lam)
    # merged [cos|sin] tables: real and imaginary parts ride one matrix product
    dft_ana: torch.Tensor    # (nlon, 2(M+1)) = [dft_cos_f | dft_sin_f]
    dft_syn: torch.Tensor    # (2(M+1), nlon) = [dft_cos_i ; dft_sin_i]
    fourier_method: str = "dft"
    # isca_tpu_torch.parallel.mesh.Mesh: selects the sharded transforms
    mesh: Any = None
    # chains per sharded transform (mesh only): chain k's all_to_all runs
    # while chain k-1's Legendre product does; 1 = one transpose
    overlap_chunks: int = 1
    m_start: int = 0        # global index of this rank's first m row
    lat_start: int = 0      # global index of this rank's first latitude
    # the products' precision ("highest", "high" or "default"), and the
    # constant tables split for it (None when the products are exact:
    # "highest" or float64): on a CUDA device precision.PackedTable's, else
    # split along their contracted axis, dft_ana_x (parts*nlon, 2(M+1)),
    # dft_syn_x (parts*2(M+1), nlon), Pw_x (parts*nlat, M+1, N+2), P_x
    # (nlat, M+1, parts*(N+2))
    precision: str = "highest"
    dft_ana_x: Any = None
    dft_syn_x: Any = None
    Pw_x: Any = None
    P_x: Any = None

    @property
    def prec(self) -> str:
        """The products' precision mode (isca_tpu's jax.lax.Precision name)."""
        return self.precision

    @property
    def spec_shape(self) -> tuple[int, int]:
        """The shape of one spectral level on this rank."""
        return (self.mvec.shape[0], self.num_spherical + 1)

    @property
    def grid_shape(self) -> tuple[int, int]:
        """The shape of one grid level on this rank (its latitude band)."""
        return (self.wts.shape[0], self.nlon)

    def local_m(self, a, axis: int = 0):
        """This rank's m rows of a global (..., M+1, ...) array or tensor."""
        return _rows(a, axis, self.m_start, self.spec_shape[0])

    def local_lat(self, a, axis: int = 0):
        """This rank's latitude band of a global (..., nlat, ...) array or tensor."""
        return _rows(a, axis, self.lat_start, self.grid_shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.P.dtype

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex64 if self.P.dtype == torch.float32 else torch.complex128

    @property
    def device(self) -> torch.device:
        return self.P.device


def _rows(a, axis, start, count):
    index = [slice(None)] * a.ndim
    index[axis] = slice(start, start + count)
    return a[tuple(index)]


def make_transforms(
    truncation: int | str,
    nlon: int | None = None,
    nlat: int | None = None,
    radius: float = 6371.0e3,
    dtype=torch.float32,
    fourier_method: str = "dft",
    make_symmetric: bool = False,
    precision: str = "highest",
    truncation_shape: str = "triangular",
    fourier_inc: int = 1,
    pad_m_to: int | None = None,
    mesh=None,
    overlap_chunks: int = 2,
    device=None,
) -> SphericalTransforms:
    """Build transform tables for a triangular or rhomboidal truncation.

    Default grid sizes follow the reference's quadratic-dealiasing table
    (nlon >= 3T+1, nlat = nlon/2). make_symmetric zeroes all m > 0 modes in
    the prognostic triangle (spectral_dynamics_nml make_symmetric,
    spherical.F90:185).

    truncation_shape='rhomboidal' retains l = n - m = 0..T for every zonal
    wavenumber (reference triang_trunc=.false., spherical.F90:603-644;
    num_total_wavenumbers = T + fourier_inc*M, spectral_dynamics.F90:430-434).

    fourier_inc keeps only zonal wavenumbers that are multiples of
    fourier_inc (spherical.F90:182 fourier_wave = m*fourier_inc); under
    triangular truncation m rows beyond T are dropped entirely.

    pad_m_to pads the m axis with structurally-zero rows so the m count is a
    multiple of pad_m_to (default: the mesh's size, else 1). Padded rows
    carry exact zeros end to end: their table entries, operator coefficients
    and triangle mask are 0.

    precision: "highest", "high" or "default", in any case (isca_tpu's
    jax.lax.Precision names; ValueError on any other): exact FP32, 3xTF32
    or one TF32 pass for every DFT and Legendre product of float32
    transforms (spectral/precision.py); float64 and fourier_method="fft"'s
    FFT ignore it.
    mesh (isca_tpu_torch.parallel.mesh.Mesh): the sharded transforms, with
    this rank's band and m block of the tables (the mesh path always runs
    the dense DFT); overlap_chunks: chains per sharded transform.
    device: where the tables live; None is the mesh's device, else CUDA
    (isca_tpu_torch.resolve_device).
    """
    if mesh is not None:
        check_mesh(mesh)
        if device is None:
            device = mesh.device
    precision = _precision.canonical(precision)
    device = resolve_device(device)
    if isinstance(truncation, str):
        truncation, d_nlon, d_nlat = RESOLUTIONS[truncation]
        nlon = nlon or d_nlon
        nlat = nlat or d_nlat

    if fourier_inc != 1 and fourier_method == "fft":
        raise ValueError("fourier_inc > 1 requires the dense 'dft' stage")
    if fourier_method not in ("dft", "fft"):
        raise ValueError(f"invalid fourier_method {fourier_method!r}")

    if truncation_shape == "rhomboidal":
        m_values = fourier_inc * np.arange(truncation + 1)
        m_max = int(m_values[-1])
        # one extra row past n = m_max + T for exact wind synthesis
        N = m_max + truncation + 1
    elif truncation_shape == "triangular":
        m_values = fourier_inc * np.arange(truncation // fourier_inc + 1)
        m_max = int(m_values[-1])
        N = truncation + 1
    else:
        raise ValueError(f"invalid truncation_shape {truncation_shape!r}")
    M = len(m_values) - 1

    if nlon is None:
        nlon = int(2 ** np.ceil(np.log2(3 * m_max + 1)))
    if nlat is None:
        nlat = nlon // 2

    mu, w = gauss.gauss_legendre(nlat)
    P = gauss.legendre_table(mu, m_max, N)[:, m_values, :]
    eps = gauss.epsilon_table(m_max, N + 1)[m_values, :]  # (M+1, N+3)

    nvals = np.arange(N + 1, dtype=np.float64)
    nn1 = nvals * (nvals + 1.0)
    inv_nn1 = np.where(nn1 > 0, 1.0 / np.where(nn1 == 0, 1.0, nn1), 0.0)

    mgrid = m_values[:, None]
    ngrid = np.arange(N + 1)[None, :]
    if truncation_shape == "rhomboidal":
        triangle = ((ngrid >= mgrid)
                    & (ngrid - mgrid <= truncation)).astype(np.float64)
    else:
        triangle = ((ngrid >= mgrid) & (ngrid <= truncation)).astype(np.float64)
    if make_symmetric:
        triangle[1:, :] = 0.0   # axisymmetric: zonal-mean modes only

    # operator coefficient tables (all float64 on host, cast once)
    mv = np.asarray(m_values, np.float64)[:, None]
    nf = nvals[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_n = np.where(nf > 0, 1.0 / np.where(nf == 0, 1.0, nf), 0.0)
    inv_np1 = 1.0 / (nf + 1.0)
    eps_n = eps[:, : N + 1]
    eps_np1 = eps[:, 1 : N + 2]
    uv_im = mv * inv_nn1[None, :]
    uv_cm = -eps_n * inv_n
    uv_cp = eps_np1 * inv_np1
    vd_im = np.broadcast_to(mv, (M + 1, N + 1)).copy()
    vd_dn = nf * eps_np1
    vd_up = (nf + 1.0) * eps_n
    cdl_up = -(nf - 1.0) * eps_n
    cdl_dn = (nf + 2.0) * eps_np1
    inv_eig = np.where(nn1 > 0, -(radius * radius) * inv_nn1, 0.0)

    # dense real-DFT matrices for the longitude stage
    lam_lon = 2.0 * np.pi * np.arange(nlon) / nlon
    ang = np.outer(lam_lon, m_values)                           # (nlon, M+1)
    dft_cos_f = np.cos(ang) / nlon
    dft_sin_f = -np.sin(ang) / nlon
    wm = np.full(M + 1, 2.0)
    wm[0] = 1.0
    dft_cos_i = wm[:, None] * np.cos(ang).T
    dft_sin_i = -wm[:, None] * np.sin(ang).T

    # m-axis zero padding (see docstring)
    M_true = M
    if pad_m_to is None:
        pad_m_to = mesh.size if mesh is not None else 1
    n_pad = (-(M + 1)) % pad_m_to
    if n_pad:
        def _pad_m(a, axis):
            width = [(0, 0)] * a.ndim
            width[axis] = (0, n_pad)
            return np.pad(a, width)
        P = _pad_m(P, 1)
        eps = _pad_m(eps, 0)
        triangle = _pad_m(triangle, 0)
        uv_im, uv_cm, uv_cp = (_pad_m(a, 0) for a in (uv_im, uv_cm, uv_cp))
        vd_im, vd_dn, vd_up = (_pad_m(a, 0) for a in (vd_im, vd_dn, vd_up))
        cdl_up, cdl_dn = _pad_m(cdl_up, 0), _pad_m(cdl_dn, 0)
        dft_cos_f, dft_sin_f = _pad_m(dft_cos_f, 1), _pad_m(dft_sin_f, 1)
        dft_cos_i, dft_sin_i = _pad_m(dft_cos_i, 0), _pad_m(dft_sin_i, 0)
        m_values = np.concatenate([m_values, np.zeros(n_pad, m_values.dtype)])
        M = M + n_pad

    Pw = P * (w[:, None, None] / 2.0)
    m_start = lat_start = 0
    if mesh is not None:
        ndev = mesh.size
        if (M + 1) % ndev or nlat % ndev:
            raise ValueError(
                f"mesh of {ndev} devices needs (m rows={M + 1}) % {ndev} == 0 "
                f"(set pad_m_to) and nlat={nlat} % {ndev} == 0")
        # this rank's m block of the spectral tables, its band of the grid ones
        m_start, m_stop = mesh.block(M + 1)
        lat_start, lat_stop = mesh.block(nlat)
        mb = slice(m_start, m_stop)
        P, Pw = P[:, mb], Pw[:, mb]
        eps, triangle, m_values = eps[mb], triangle[mb], m_values[mb]
        uv_im, uv_cm, uv_cp = uv_im[mb], uv_cm[mb], uv_cp[mb]
        vd_im, vd_dn, vd_up = vd_im[mb], vd_dn[mb], vd_up[mb]
        cdl_up, cdl_dn = cdl_up[mb], cdl_dn[mb]
        mu, w = mu[lat_start:lat_stop], w[lat_start:lat_stop]

    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float64)).to(
        device=device, dtype=dtype)
    dft_ana = np.concatenate([dft_cos_f, dft_sin_f], axis=1)
    dft_syn = np.concatenate([dft_cos_i, dft_sin_i], axis=0)
    split = {}
    if _precision.splits(precision, dtype):
        # rounded on the host once, as the plain version rounds; packed for
        # the kernel on a CUDA device (spectral/precision.py)
        cut = lambda x, kind: _precision.table_for(
            torch.as_tensor(np.ascontiguousarray(x, np.float64)).to(torch.float32),
            kind, precision, device)
        split = dict(dft_ana_x=cut(dft_ana, "dft"), dft_syn_x=cut(dft_syn, "dft"),
                     Pw_x=cut(Pw, "analysis"), P_x=cut(P, "synthesis"))
    return SphericalTransforms(
        truncation=truncation,
        num_fourier=M,
        num_fourier_true=M_true,
        num_spherical=N,
        nlon=nlon,
        nlat=nlat,
        radius=float(radius),
        wts=f(w),
        sinlat=f(mu),
        coslat=f(np.sqrt(1.0 - mu * mu)),
        lats=f(np.arcsin(mu)),
        lons=f(2.0 * np.pi * np.arange(nlon) / nlon),
        P=f(P),
        Pw=f(Pw),
        eps=f(eps),
        mvec=f(np.asarray(m_values, np.float64)),
        nn1=f(nn1),
        inv_nn1=f(inv_nn1),
        triangle=f(triangle),
        eigenvalues=f(-nn1 / (radius * radius)),
        uv_im=f(uv_im),
        uv_cm=f(uv_cm),
        uv_cp=f(uv_cp),
        vd_im=f(vd_im),
        vd_dn=f(vd_dn),
        vd_up=f(vd_up),
        cdl_up=f(cdl_up),
        cdl_dn=f(cdl_dn),
        inv_eig=f(inv_eig),
        dft_cos_f=f(dft_cos_f),
        dft_sin_f=f(dft_sin_f),
        dft_cos_i=f(dft_cos_i),
        dft_sin_i=f(dft_sin_i),
        dft_ana=f(dft_ana),
        dft_syn=f(dft_syn),
        fourier_method=fourier_method,
        mesh=mesh,
        overlap_chunks=max(int(overlap_chunks), 1),
        m_start=m_start,
        lat_start=lat_start,
        precision=precision,
        **split,
    )


# ---------------------------------------------------------------------------
# The DFT and Legendre products at the transforms' precision.
# ---------------------------------------------------------------------------

def _product(T: SphericalTransforms, x: torch.Tensor, kind: str,
             table: torch.Tensor, table_x) -> torch.Tensor:
    """The product of `kind` (spectral/precision.py KINDS) contracting x
    with `table`, at T's precision: exact with the table as it is, else
    against the table's split `table_x` (on a CUDA tensor one launch of the
    tf32_product kernel)."""
    if table_x is None:
        return _precision.contract(kind, table, x)
    return _precision.product(x, kind, table_x, T.precision)


# ---------------------------------------------------------------------------
# Fourier (longitude) stage.  Grid tensors are (..., lat, lon); Fourier
# tensors are complex (..., lat, m) with m = 0..M.
# ---------------------------------------------------------------------------

def grid_to_fourier(T: SphericalTransforms, g: torch.Tensor) -> torch.Tensor:
    """Longitude Fourier analysis, normalized so F_0 is the zonal mean; m <= M.

    Default: one dense real-DFT matrix product giving [Re | Im]; 'fft' uses
    torch.fft.rfft.
    """
    with record_function("dft"):
        if T.fourier_method == "fft":
            F = torch.fft.rfft(g, dim=-1) / T.nlon
            F = F[..., : T.num_fourier_true + 1].to(T.cdtype)
            if T.num_fourier != T.num_fourier_true:  # padded m rows are exact zeros
                F = torch.nn.functional.pad(F, (0, T.num_fourier - T.num_fourier_true))
            return F
        M1 = T.num_fourier + 1
        FF = _product(T, g, "dft", T.dft_ana, T.dft_ana_x)
        return torch.complex(FF[..., :M1], FF[..., M1:])


def fourier_to_grid(T: SphericalTransforms, F: torch.Tensor) -> torch.Tensor:
    """Inverse of grid_to_fourier (zero-padding m > M, i.e. spectral interpolation)."""
    with record_function("dft"):
        if T.fourier_method == "fft":
            nfreq = T.nlon // 2 + 1
            Ffull = torch.nn.functional.pad(F, (0, nfreq - F.shape[-1]))
            return torch.fft.irfft(Ffull * T.nlon, n=T.nlon, dim=-1).to(T.dtype)
        return _product(T, torch.cat([F.real, F.imag], dim=-1), "dft", T.dft_syn,
                        T.dft_syn_x).to(T.dtype)


# ---------------------------------------------------------------------------
# Legendre stage.  Fourier (..., lat, m) <-> spectral (..., m, n).
# ---------------------------------------------------------------------------

def fourier_to_spec(T: SphericalTransforms, F: torch.Tensor) -> torch.Tensor:
    """Legendre analysis: s_mn = (1/2) sum_j F(j,m) Pbar_mn(j) w_j.

    The Pbar*w table is real, so the complex contraction runs as one real
    batched product over the split (re, im) parts (trailing axis r).
    """
    with record_function("legendre"):
        ss = _product(T, torch.view_as_real(F), "analysis", T.Pw, T.Pw_x)
        return torch.view_as_complex(ss.contiguous())


def spec_to_fourier(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """Legendre synthesis: F(j,m) = sum_n s_mn Pbar_mn(j), as one real
    batched product over the split (re, im) parts."""
    with record_function("legendre"):
        FF = _product(T, torch.view_as_real(s), "synthesis", T.P, T.P_x)
        return torch.view_as_complex(FF.contiguous())


def grid_to_spec(T: SphericalTransforms, g: torch.Tensor,
                 truncate: bool = True) -> torch.Tensor:
    """Full forward transform (reference: trans_grid_to_spherical, transforms.F90:462)."""
    if T.mesh is not None:
        s = _pipeline(T, g, _analysis_send, _analysis_recv)
    else:
        s = fourier_to_spec(T, grid_to_fourier(T, g))
    return triangular_truncate(T, s) if truncate else s


def spec_to_grid(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """Full inverse transform (reference: trans_spherical_to_grid, transforms.F90:379)."""
    if T.mesh is not None:
        return _pipeline(T, s, _synthesis_send, _synthesis_recv)
    return fourier_to_grid(T, spec_to_fourier(T, s))


# ---------------------------------------------------------------------------
# Sharded transpose-method transforms (isca_tpu's _grid_to_spec_shmap and
# _spec_to_grid_shmap; reference: transforms.F90:970-1056 + spec_mpp.F90).
# Grid space is lat-sharded, spectral space m-sharded; the re-partition is
# one all_to_all per chain, each element moving once. The (re, im) parts
# travel as one real tensor whose leading axis is the destination rank.
# ---------------------------------------------------------------------------

def _chunk_bounds(n: int, k: int):
    """<=k contiguous chunk boundaries covering n rows (all non-empty)."""
    k = max(1, min(int(k), int(n)))
    bounds = np.linspace(0, n, k + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _pipeline(T: SphericalTransforms, x: torch.Tensor, send, recv) -> torch.Tensor:
    """Run send (local stage, then an async all_to_all) and recv (wait, then
    the other local stage) over chains of x's leading axis, issuing chain
    k's transpose before chain k-1's second stage."""
    chains = [None]           # the whole of x
    if T.overlap_chunks > 1 and x.ndim >= 3 and x.shape[0] > 1:
        chains = _chunk_bounds(x.shape[0], T.overlap_chunks)
    outs, pending = [], None
    for chain in chains:
        sent = send(T, x if chain is None else x[chain[0]:chain[1]])
        if pending is not None:
            outs.append(recv(T, *pending))
        pending = sent
    outs.append(recv(T, *pending))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _analysis_send(T, g):
    """Local DFT of the band, then the transpose: rank r gets the band's
    coefficients of its m block, as (size, ..., lat_band, m_block, 2)."""
    n, lead = T.mesh.size, g.shape[:-2]
    k = len(lead)
    with record_function("dft"):
        FF = _product(T, g, "dft", T.dft_ana, T.dft_ana_x)   # (..., lat_band, 2 (M+1))
    FF = FF.reshape(*lead, g.shape[-2], 2, n, T.spec_shape[0])
    FF = FF.permute(k + 2, *range(k), k, k + 3, k + 1)
    return T.mesh.all_to_all(FF, async_op=True) + (lead,)


def _analysis_recv(T, out, work, lead):
    """All latitudes of this rank's m block, then the local Legendre analysis."""
    work.wait()
    F = out.movedim(0, len(lead)).reshape(*lead, T.nlat, T.spec_shape[0], 2)
    with record_function("legendre"):
        ss = _product(T, F, "analysis", T.Pw, T.Pw_x)
    return torch.view_as_complex(ss.contiguous())


def _synthesis_send(T, s):
    """Local Legendre synthesis of the m block on all latitudes, then the
    transpose: rank r gets band r, as (size, ..., lat_band, m_block, 2)."""
    n, lead = T.mesh.size, s.shape[:-2]
    with record_function("legendre"):
        FF = _product(T, torch.view_as_real(s), "synthesis", T.P, T.P_x)
    FF = FF.reshape(*lead, n, T.nlat // n, T.spec_shape[0], 2).movedim(len(lead), 0)
    return T.mesh.all_to_all(FF, async_op=True) + (lead,)


def _synthesis_recv(T, out, work, lead):
    """Every m block of this rank's band as [Re | Im] over m, then the local
    inverse DFT."""
    work.wait()
    k = len(lead)
    F = out.permute(*range(1, k + 1), k + 1, k + 3, 0, k + 2)
    F = F.reshape(*lead, out.shape[k + 1], 2 * (T.num_fourier + 1))
    with record_function("dft"):
        return _product(T, F, "dft", T.dft_syn, T.dft_syn_x).to(T.dtype)


# ---------------------------------------------------------------------------
# Spectral-space operators (reference: spherical.F90).
# ---------------------------------------------------------------------------

def triangular_truncate(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """Zero modes outside the triangle m <= n <= T (spherical.F90:564-600)."""
    return s * T.triangle


def laplacian(T: SphericalTransforms, s: torch.Tensor, power: int = 1) -> torch.Tensor:
    """(nabla^2)^power: diagonal multiply by (-n(n+1)/a^2)^power."""
    return s * T.eigenvalues ** power


def inverse_laplacian(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """nabla^-2 (zero at n=0): used for streamfunction from vorticity."""
    return s * T.inv_eig


def ddx_spec(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """d/dlambda in spectral space: multiply by i*m (spherical.F90 coef_dx)."""
    return s * (T.mvec[:, None] * 1j)


def _shift_down(s: torch.Tensor) -> torch.Tensor:
    """result_n = s_{n+1} (zero at top)."""
    return torch.nn.functional.pad(s[..., 1:], (0, 1))


def _shift_up(s: torch.Tensor) -> torch.Tensor:
    """result_n = s_{n-1} (zero at bottom)."""
    return torch.nn.functional.pad(s[..., :-1], (1, 0))


def cos_dlat_coeffs(T: SphericalTransforms, s: torch.Tensor) -> torch.Tensor:
    """Spectral coefficients g such that synth(g) = cos(lat) * d(synth(s))/d(lat).

    Uses (1-mu^2) dPbar_n/dmu = -n eps_{m,n+1} Pbar_{n+1} + (n+1) eps_{m,n} Pbar_{n-1}:
      g_n = -(n-1) eps_{m,n} s_{n-1} + (n+2) eps_{m,n+1} s_{n+1}
    """
    return T.cdl_up * _shift_up(s) + T.cdl_dn * _shift_down(s)


# ---------------------------------------------------------------------------
# Wind <-> (vorticity, divergence)  (reference: spherical.F90:409-484 +
# transforms.F90:681-783).
# ---------------------------------------------------------------------------

def uv_coeffs_from_vor_div(T: SphericalTransforms, vors: torch.Tensor,
                           divs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Spectral wind coefficients (U, V) with u = synth(U)/cos, v = synth(V)/cos.

      U_n = a [ -i m D_n /(n(n+1)) - eps_mn zeta_{n-1}/n + eps_{m,n+1} zeta_{n+1}/(n+1) ]
      V_n = a [ -i m zeta_n /(n(n+1)) + eps_mn D_{n-1}/n - eps_{m,n+1} D_{n+1}/(n+1) ]

    Uses the n = T+1 overflow row, making the synthesis exact for
    triangularly-truncated (vor, div). Split out so callers can batch the
    wind synthesis with other fields in one spec_to_grid.
    """
    im_inv = T.uv_im * (-1j)
    cm = T.uv_cm      # multiplies x_{n-1}
    cp = T.uv_cp      # multiplies x_{n+1}
    U = T.radius * (im_inv * divs + cm * _shift_up(vors) + cp * _shift_down(vors))
    V = T.radius * (im_inv * vors - cm * _shift_up(divs) - cp * _shift_down(divs))
    return U, V


def uv_grid_from_vor_div(T: SphericalTransforms, vors: torch.Tensor,
                         divs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid winds (u, v) from spectral vorticity/divergence
    (reference: spherical.F90:409-484 + transforms.F90:681-783)."""
    U, V = uv_coeffs_from_vor_div(T, vors, divs)
    coslat = T.coslat[:, None]
    # one batched synthesis for both wind components
    UV = spec_to_grid(T, torch.stack([U, V], dim=0))
    return UV[0] / coslat, UV[1] / coslat


def vor_div_from_uv_grid(T: SphericalTransforms, u: torch.Tensor, v: torch.Tensor,
                         truncate: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Spectral (vorticity, divergence) from grid winds.

    With a_n = analysis(u/cos), b_n = analysis(v/cos):
      zeta_n = (1/a)[ i m b_n - n eps_{m,n+1} a_{n+1} + (n+1) eps_mn a_{n-1} ]
      D_n    = (1/a)[ i m a_n + n eps_{m,n+1} b_{n+1} - (n+1) eps_mn b_{n-1} ]
    """
    coslat = T.coslat[:, None]
    AB = grid_to_spec(T, torch.stack([u / coslat, v / coslat], dim=0), truncate=False)
    return vor_div_from_analysis(T, AB[0], AB[1], truncate=truncate)


def vor_div_from_analysis(T: SphericalTransforms, A: torch.Tensor, B: torch.Tensor,
                          truncate: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the (vor, div) recurrences to already-analyzed A = spec(u/cos),
    B = spec(v/cos): the operator half of vor_div_from_uv_grid, split out so
    the dycore can batch the u/cos, v/cos analysis with other fields."""
    im = T.vd_im * 1j
    c_dn = T.vd_dn        # multiplies x_{n+1}
    c_up = T.vd_up        # multiplies x_{n-1}
    vor = (im * B - c_dn * _shift_down(A) + c_up * _shift_up(A)) / T.radius
    div = (im * A + c_dn * _shift_down(B) - c_up * _shift_up(B)) / T.radius
    if truncate:
        vor = triangular_truncate(T, vor)
        div = triangular_truncate(T, div)
    return vor, div


def horizontal_advection(T: SphericalTransforms, f_spec: torch.Tensor,
                         u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """-(V . grad f) on the grid from spectral f (transforms.F90:786-831).

    Advective form via spectral derivatives:
      dxf = synth(i m f)        ( = cos(lat) * (1/(a cos)) df/dlambda * a )
      dyf = synth(H f)          ( = cos(lat) * df/dlat )
      adv = -(u dxf + v dyf) / (a cos(lat))
    """
    grads = spec_to_grid(
        T, torch.stack([ddx_spec(T, f_spec), cos_dlat_coeffs(T, f_spec)], dim=0))
    coslat = T.coslat[:, None]
    return -(u * grads[0] + v * grads[1]) / (T.radius * coslat)


def area_weighted_mean(T: SphericalTransforms, g: torch.Tensor) -> torch.Tensor:
    """Area-weighted global mean over the trailing (lat, lon) axes (always
    exact: it is the measuring stick of the mass and energy fixers). On a
    mesh: the band's partial sum, then an all_reduce in g's dtype."""
    w = (T.wts / 2.0).to(g.dtype)
    mean = torch.einsum("...jk,j->...", g, w) / T.nlon
    return mean if T.mesh is None else T.mesh.all_reduce(mean)


def grid_max(T: SphericalTransforms, g: torch.Tensor) -> torch.Tensor:
    """The largest value of a grid tensor over the whole globe."""
    return g.max() if T.mesh is None else T.mesh.all_reduce(g.max(), "max")


def grid_min(T: SphericalTransforms, g: torch.Tensor) -> torch.Tensor:
    """The smallest value of a grid tensor over the whole globe."""
    return g.min() if T.mesh is None else T.mesh.all_reduce(g.min(), "min")


def gaussian_weights(T: SphericalTransforms) -> torch.Tensor:
    """The (nlat,) Gaussian weights of the whole globe in T's dtype, on any
    rank (T.wts holds only the band on a mesh)."""
    if T.mesh is None:
        return T.wts
    return torch.as_tensor(gauss.gauss_legendre(T.nlat)[1]).to(device=T.device,
                                                                dtype=T.dtype)


def global_lats(T: SphericalTransforms) -> torch.Tensor:
    """The (nlat,) latitudes [rad] of the whole globe in T's dtype, on any
    rank (T.lats holds only the band on a mesh): what is built on the whole
    globe and then cut to the band (seeded series, topography)."""
    if T.mesh is None:
        return T.lats
    mu = gauss.gauss_legendre(T.nlat)[0]
    return torch.as_tensor(np.arcsin(mu)).to(device=T.device, dtype=T.dtype)


def coriolis_grid(T: SphericalTransforms, omega: float) -> torch.Tensor:
    """Planetary vorticity f = 2*Omega*sin(lat) on the grid, shape grid_shape."""
    return (2.0 * omega * T.sinlat[:, None]).expand(*T.grid_shape)
