"""Builds the port's CUDA kernels from `csrc/` at first use.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, `_build/<key>/lib<name>.so`, and loaded with
ctypes. The key hashes the sources and the flags, so an edited source builds
anew. All sources compile at once, one nvcc process each. Nothing outside the
package's own sources is compiled in.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / h.hexdigest()[:16]


def build() -> dict[str, str]:
    """Compile every source not yet built, all in parallel.

    Returns {name: the compiler's report} for the sources compiled by this
    call (ptxas register and spill lines). Raises with nvcc's output if any
    source fails.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          tmp, lib)
    reports, errors = {}, []
    for name, (proc, tmp, lib) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                          f"{stderr}{stdout}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
            reports[name] = stderr + stdout
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build()
    return ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
