"""The matrix products of the spherical transforms at a chosen precision.

isca_tpu names the precision of its transform products with
`jax.lax.Precision` (isca_tpu/spectral/transforms.py: the `prec` property,
applied to every DFT and Legendre einsum). The port accepts the same three
names, in any case, and computes on an NVIDIA Hopper card:

* "highest": exact IEEE FP32 products (cuBLAS with TF32 off), as on the CPU.
  On a TPU it is the 6-pass bf16 emulation of FP32 on the MXU.
* "high": 3xTF32. Each float32 operand `a` is split into
  a_hi = round_to_tf32(a) and a_lo = round_to_tf32(a - a_hi), each rounded
  to nearest even on the 13 low mantissa bits (11 significant bits kept),
  and a.b is computed as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with FP32 sums.
  On a TPU it is the 3-pass bf16_3x product (8 bits a part), which
  PRECISION_GATE.json climate-validated on the TPU: this is its counterpart
  on the card, and each part carries 11 bits instead of 8. The three passes
  are one TF32 cuBLAS product over an axis three times as deep: the data
  operand becomes [a_hi | a_hi | a_lo] and the constant table
  [b_hi | b_lo | b_hi] along the contracted axis.
* "default": one TF32 pass, a_hi.b_hi with FP32 sums: what
  `jax.lax.Precision.DEFAULT` means on an NVIDIA GPU. On a TPU it is one
  bf16 pass, less accurate than this.

Float64 ignores the mode, as XLA does for float64 dots. isca_tpu on the CPU
computes exact products at every mode (its three modes give bit-equal
einsums there), so the port's "high" and "default" differ from it on the CPU
by the rounding above.

The operands are rounded before the product, so the tensor cores' own
handling of the low mantissa bits never matters: a product of two values of
11 significant bits is exact in FP32. The sums differ from the plain version
here (`split_reference`, then exact FP32 products on the CPU): cuBLAS sums in
another order, and the card's TF32 tensor cores round their sums toward
zero where FP32 rounds to nearest (measured on an H100: a mean error of
-3.75 units of 2^-24 |a||b| on positive operands, none on zero-mean ones).
The tests and chip_smoke.py hold the card to the plain version with bounds
that allow for both. The data operand is split on the card by a kernel
written for it (csrc/tf32_split.cu), the constant tables once, when the
transforms are built. TF32 is switched on only around the products
(`tf32_products`) and restored after them, so it reaches no other product
of the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

MODES = ("highest", "high", "default")
# operand parts along the contracted axis: data [hi, hi, lo] and table
# [hi, lo, hi] for "high", hi for "default"
PARTS = {"high": 3, "default": 1}
TF32_DROPPED_BITS = 13          # float32's 23 mantissa bits less TF32's 10


def canonical(precision) -> str:
    """The mode's name in lower case, as jax.lax.Precision(name.lower())
    accepts it; ValueError on any other name."""
    name = str(precision).lower()
    if name not in MODES:
        raise ValueError(f"{precision!r} is not a valid transform precision: "
                         f"expected one of {MODES}, in any case")
    return name


def splits(precision, dtype) -> bool:
    """Whether products at this mode and dtype split their operands (float32
    at "high" or "default"); otherwise they are exact."""
    return dtype == torch.float32 and canonical(precision) != "highest"


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties to even, as a float32 whose 13 low mantissa bits are zero. Inf and
    NaN pass through; a value that rounds past the largest float becomes
    inf. Int32 bit arithmetic, on any device."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_to_tf32: expected float32, got {x.dtype}")
    i = x.view(torch.int32)
    half = (1 << (TF32_DROPPED_BITS - 1)) - 1
    r = (i + half + ((i >> TF32_DROPPED_BITS) & 1)) & -(1 << TF32_DROPPED_BITS)
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def split_reference(x: torch.Tensor, axis: int, precision) -> torch.Tensor:
    """Plain PyTorch version of `split`: the data operand's parts,
    concatenated along `axis` ([hi, hi, lo] at "high", hi at "default")."""
    hi = round_to_tf32(x)
    if PARTS[canonical(precision)] == 1:
        return hi
    return torch.cat([hi, hi, round_to_tf32(x - hi)], dim=axis)


def split_table(b: torch.Tensor, axis: int, precision) -> torch.Tensor:
    """A constant table's parts along its contracted `axis` ([hi, lo, hi] at
    "high", hi at "default"): the partner of split's data layout."""
    hi = round_to_tf32(b)
    if PARTS[canonical(precision)] == 1:
        return hi
    return torch.cat([hi, round_to_tf32(b - hi), hi], dim=axis)


@functools.cache
def _split_lib():
    from isca_tpu_torch import _build

    lib = _build.load("tf32_split")
    lib.tf32_split_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.tf32_split_f32.restype = ctypes.c_int
    lib.tf32_split_error_string.argtypes = [ctypes.c_int]
    lib.tf32_split_error_string.restype = ctypes.c_char_p
    return lib


def split(x: torch.Tensor, axis: int, precision) -> torch.Tensor:
    """The data operand of a product at `precision`, split into its TF32
    parts along the contracted `axis`: one launch of csrc/tf32_split.cu on a
    CUDA tensor, `split_reference` on a CPU one.

    On CUDA x must be float32 and contiguous; anything else raises. Each
    kernel launch adds one to `split.launches`.
    """
    mode = canonical(precision)
    if mode == "highest":
        raise ValueError("split: 'highest' products are exact and split nothing")
    if x.device.type == "cpu":
        return split_reference(x, axis, mode)
    if x.device.type != "cuda":
        raise ValueError(f"split: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"split: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("split: x is not contiguous")
    axis = axis % x.dim()
    parts = PARTS[mode]
    shape = list(x.shape)
    # x as (outer, inner): the axes before `axis`, then `axis` and the rest
    outer, inner = math.prod(shape[:axis]), math.prod(shape[axis:])
    shape[axis] *= parts
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _split_lib()
    rc = lib.tf32_split_f32(x.data_ptr(), out.data_ptr(), outer, inner, parts,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32_split launch failed: CUDA error {rc} "
                           f"({lib.tf32_split_error_string(rc).decode()})")
    split.launches += 1
    return out


split.launches = 0


@contextlib.contextmanager
def tf32_products(device):
    """TF32 for cuBLAS float32 products on `device` inside the block, and the
    switch as it was after it, whatever happens inside. Nothing on the CPU.
    The port sets the switch through `allow_tf32` only (isca_tpu_torch's
    import turns it off), so its state is always read the same way."""
    if torch.device(device).type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = was
