"""Threefry-2x32 random numbers, bit for bit as `jax.random` draws them.

isca_tpu's stirring (isca_tpu/physics/stirring.py) threads a raw
`jax.random.PRNGKey` through the model state and draws with
`jax.random.split` and `jax.random.uniform`, and its goldens depend on
those exact draws. This module reproduces them in torch:

* `prng_key(seed)` is `jax.random.PRNGKey(seed)`: the 64-bit seed bit-cast
  to two 32-bit words (high, low), a `uint32[2]` tensor;
* `split(key, num)` is `jax.random.split` and `uniform(key, shape, dtype,
  minval, maxval)` is `jax.random.uniform`, both in JAX's default
  `jax_threefry_partitionable=True` mode: each output element i hashes the
  64-bit counter i, split into (high, low) 32-bit words, under the key
  (JAX's `iota_2x32_shape`, `_threefry_split_foldlike` and
  `_threefry_random_bits_partitionable`);
* `uniform` turns the bits into floats as JAX's `_uniform` does: the top
  mantissa bits under the exponent of 1.0, minus 1, scaled to the range.

The hash (Salmon et al. 2011; JAX's `_threefry2x32_lowering`) is 20 rounds
of add, rotate and xor on 32-bit words. torch's uint32 has few kernels, so
each word is held in int64 and masked to 32 bits after every add and
rotate. The key stays on its device (no host round trip), and a key in a
model state is a uint32[2] tensor, as isca_tpu's restart stores it. This is
code that JAX left to XLA, not a Pallas kernel, so it is plain torch ops,
each call inside a profiler range named "threefry".
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from isca_tpu_torch import resolve_device

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): uint32[2] (seed >> 32, seed & 0xFFFFFFFF),
    on `device` (None is CUDA)."""
    s = int(seed) & (2**64 - 1)
    words = torch.tensor([(s >> 32) & MASK32, s & MASK32], dtype=torch.int64)
    return words.to(device=resolve_device(device)).to(torch.uint32)


def _rotl(x, d):
    return ((x << d) & MASK32) | (x >> (32 - d))


def _round(x0, x1, d):
    x0 = (x0 + x1) & MASK32
    return x0, x0 ^ _rotl(x1, d)


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the word pairs (x0, x1) under key (k1, k2):
    int64 tensors holding 32-bit words, k1 and k2 0-d."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0, x1 = _round(x0, x1, d)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _hash_iota(key: torch.Tensor, shape) -> tuple[torch.Tensor, torch.Tensor]:
    """Both hash words of the counters 0..prod(shape)-1 laid out in `shape`
    (JAX's iota_2x32_shape: counter i as high and low 32-bit words)."""
    k = key.to(torch.int64)
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    return threefry2x32(k[0], k[1], iota >> 32, iota & MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (num, 2) keys of the key's dtype."""
    with record_function("threefry"):
        b1, b2 = _hash_iota(key, (num,))
        return torch.stack([b1, b2], dim=-1).to(key.dtype)


def uniform(key: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval), float32 or
    float64, on the key's device."""
    shape = tuple(shape)
    with record_function("threefry"):
        b1, b2 = _hash_iota(key, shape)
        if dtype == torch.float32:
            mant = (b1 ^ b2) >> 9                          # top 23 of 32 bits
            floats = (mant | 0x3F800000).to(torch.int32).view(torch.float32)
        elif dtype == torch.float64:
            mant = (b1 << 20) | (b2 >> 12)                 # top 52 of 64 bits
            floats = (mant | 0x3FF0000000000000).view(torch.float64)
        else:
            raise ValueError(f"uniform draws float32 or float64, not {dtype}")
        # minval, maxval and their difference rounded to the dtype, as JAX
        # converts them before it scales
        npt = np.float32 if dtype == torch.float32 else np.float64
        lo, hi = npt(minval), npt(maxval)
        return torch.clamp_min((floats - 1.0) * float(hi - lo) + float(lo), float(lo))
