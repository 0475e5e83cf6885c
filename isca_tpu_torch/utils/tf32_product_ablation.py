"""Where csrc/tf32_product.cu spends its time, on the card: copies of the
kernel with one part taken out, timed beside the kernel.

    python -m isca_tpu_torch.utils.tf32_product_ablation

builds each copy with nvcc (the flags of `_build.py`) into
`isca_tpu_torch/_build/ablation/`, and times it and the kernel at the four
products of Held-Suarez T85L25 and the giant planet T213L30 (3 fields of
all levels), at "high" and "default": the device time of 20 calls under
torch.profiler, per call, in two rounds. A copy without a part computes a
wrong result; only its time is read. Prints one JSON line per copy, product
and mode, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from isca_tpu_torch import _build
from isca_tpu_torch.spectral import precision as prec
from isca_tpu_torch.spectral import transforms as ttr

# copy name -> {source text: its replacement}
ABLATIONS = {
    "kernel": {},
    # the products: each wgmma call returns before its instruction
    "no_tensor_cores": {
        "uint64_t b, int accumulate) {":
            "uint64_t b, int accumulate) {\n"
            "  if (accumulate >= 0) { d[0] += __uint_as_float(a[0]) + float(b & 1); return; }"},
    # the copies of x into the staged tiles
    "no_x_loads": {
        "cp_async16(xs + r * kXPitch + kk, ok ? p.x + base + k : p.x, ok);": "",
        "cp_async4(xs + r * kXPitch + kk, ok ? p.x + base + k * p.sxk : p.x, ok);": ""},
    # the copies of the table's tiles
    "no_table_loads": {
        "cp_async16(dst + s * kStep + 4 * w, src + s * groups * 64 + 4 * w, true);": ""},
    # the output's stores
    "no_output_store": {
        "if (base >= 0 && c < p.N)\n": "if (base >= 0 && c < p.N && tot_hh[i] == 12345.0f)\n"},
}
PRODUCTS = {"dft_analysis": ("dft", "dft_ana"), "legendre_analysis": ("analysis", "Pw"),
            "legendre_synthesis": ("synthesis", "P"), "dft_synthesis": ("dft", "dft_syn")}
SHAPES = (("T85", 25), ("T213", 30))
FIELDS = 3


def build(out_dir):
    """{copy name: its library}, all built at once."""
    src = (_build.CSRC / "tf32_product.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in ABLATIONS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"ablation {name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on ablation {name}:\n{err}{out}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def use(lib):
    """Route precision.product through `lib`."""
    real = prec._product_lib()
    lib.tf32_product_f32.argtypes = real.tf32_product_f32.argtypes
    lib.tf32_product_f32.restype = ctypes.c_int
    lib.tf32_product_error_string.argtypes = [ctypes.c_int]
    lib.tf32_product_error_string.restype = ctypes.c_char_p
    prec._product_lib = lambda: lib


def device_ms(fn, reps=20):
    """Device time of one fn() call under torch.profiler over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in p.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError("device_ms: the profiler saw no device time")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tf32_product_ablation: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    libs = build(_build.BUILD / "ablation")
    rng = np.random.default_rng(1)
    cases = []
    for res, L in SHAPES:
        for mode in ("high", "default"):
            T = ttr.make_transforms(res, dtype=torch.float32, precision=mode)
            M1, N1 = T.num_fourier + 1, T.num_spherical + 1
            shape = {"dft_analysis": (T.nlat, T.nlon), "legendre_analysis": (T.nlat, M1, 2),
                     "legendre_synthesis": (M1, N1, 2), "dft_synthesis": (T.nlat, 2 * M1)}
            for name, (kind, attr) in PRODUCTS.items():
                x = torch.as_tensor(rng.standard_normal((FIELDS, L) + shape[name])
                                    .astype(np.float32), device="cuda")
                cases.append((f"{res}L{L}", mode, name, kind, getattr(T, attr + "_x"), x))
    times = {}
    for _ in range(args.rounds):
        for copy, lib in libs.items():
            use(lib)
            for shape, mode, name, kind, table, x in cases:
                ms = device_ms(lambda: prec.product(x, kind, table, mode))
                times.setdefault((copy, shape, mode, name), []).append(ms)
    for (copy, shape, mode, name), ms in times.items():
        print(json.dumps({"copy": copy, "shape": shape, "mode": mode, "product": name,
                          "ms": ms, "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
