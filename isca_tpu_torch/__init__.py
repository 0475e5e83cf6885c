"""isca_tpu_torch: the PyTorch/CUDA port of isca_tpu for NVIDIA Hopper GPUs.

The package mirrors isca_tpu's module paths and names so each ported module
sits where its JAX counterpart does. It imports torch and numpy only. Plain
tensor code is PyTorch; each Pallas kernel of isca_tpu becomes a CUDA kernel
written by hand under `csrc/`, built at first use by `_build.py`.

Entry points take an explicit `device`. With `device=None` they run on CUDA
and raise when no CUDA device is present; pass `device="cpu"` to run the
plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# The reference's float32 numerics are exact FP32 (no TF32) on every path.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "isca_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
