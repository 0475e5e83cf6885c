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
  and a.b is computed as a_hi.b_hi + (a_hi.b_lo + a_lo.b_hi) with FP32
  sums. On a TPU it is the 3-pass bf16_3x product (8 bits a part), which
  PRECISION_GATE.json climate-validated on the TPU: this is its counterpart
  on the card, and each part carries 11 bits instead of 8.
* "default": one TF32 pass, a_hi.b_hi with FP32 sums: what
  `jax.lax.Precision.DEFAULT` means on an NVIDIA GPU. On a TPU it is one
  bf16 pass, less accurate than this.

Float64 ignores the mode, as XLA does for float64 dots. isca_tpu on the CPU
computes exact products at every mode (its three modes give bit-equal
einsums there), so the port's "high" and "default" differ from it on the CPU
by the rounding above.

A product is one of three kinds (`KINDS`): "dft", x (..., K) @ T (K, N), the
longitude stage both ways; "analysis", einsum("jmn,...jmr->...mnr", Pw, x),
the Legendre analysis (one product over j per m); "synthesis",
einsum("jmn,...mnr->...jmr", P, x), the Legendre synthesis (over n per m).
`product` computes one at "high" or "default": on a CUDA tensor one launch
of csrc/tf32_product.cu, which splits x in registers as it loads it and
runs the products on the tensor cores against a table split and packed once
(`pack_table`); on a CPU tensor the plain version, `product_reference`: x
split by `split_reference` into [hi | hi | lo] along the contracted axis
against the table's [hi | lo | hi] (`split_table`), one exact product three
times as deep.

The operands are rounded before the product, so the tensor cores' own
handling of the low mantissa bits never matters: a product of two values of
11 significant bits is exact in FP32. The sums differ from the plain
version: the kernel adds in another order, lets the tensor cores sum 32
terms at a time (their sums round toward zero) and adds those partial sums
in FP32 to nearest, and the tensor cores flush subnormal operands. The tests
and chip_smoke.py hold the card to the plain version with bounds that allow
for that. `tf32_products` switches cuBLAS's TF32 on around a block; no
product of the port uses it (chip_smoke.py times a TF32 cuBLAS product
beside the kernel with it).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

MODES = ("highest", "high", "default")
# operand parts along the contracted axis in the plain version: data
# [hi, hi, lo] and table [hi, lo, hi] for "high", hi for "default"
PARTS = {"high": 3, "default": 1}
# the table's parts in the kernel's layout: hi and lo, or hi
TABLE_PARTS = {"high": 2, "default": 1}
TF32_DROPPED_BITS = 13          # float32's 23 mantissa bits less TF32's 10

KINDS = ("dft", "analysis", "synthesis")
# the contracted axis of the data operand, and of the table as the
# transforms keep it (dft (K, N), Pw (j, m, n), P (j, m, n)), by kind
DATA_AXIS = {"dft": -1, "analysis": -3, "synthesis": -2}
TABLE_AXIS = {"dft": 0, "analysis": 0, "synthesis": 2}

# csrc/tf32_product.cu's block tile: rows of x, table columns, contraction
# per stage (the tensor cores' sums between FP32 adds), stages, threads;
# the C entry reports its own and the wrapper checks them against these
TILE_ROWS, TILE_COLS, TILE_K = 64, 64, 32
STAGES, THREADS = 3, 128
MAX_GRID = 65535                # grid y (row tiles) and z (groups)
MAX_SMEM_BYTES = 232448         # dynamic shared memory a block may use on Hopper


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


def _split_mode(precision) -> str:
    mode = canonical(precision)
    if mode == "highest":
        raise ValueError("'highest' products are exact and split nothing")
    return mode


def _kind(kind) -> str:
    if kind not in KINDS:
        raise ValueError(f"product kind {kind!r}: expected one of {KINDS}")
    return kind


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
    """The data operand's parts, concatenated along `axis` ([hi, hi, lo] at
    "high", hi at "default")."""
    hi = round_to_tf32(x)
    if PARTS[canonical(precision)] == 1:
        return hi
    return torch.cat([hi, hi, round_to_tf32(x - hi)], dim=axis)


def split(x: torch.Tensor, axis: int, precision) -> torch.Tensor:
    """`split_reference` at a mode that splits: ValueError at "highest"."""
    return split_reference(x, axis, _split_mode(precision))


def split_table(b: torch.Tensor, axis: int, precision) -> torch.Tensor:
    """A constant table's parts along its contracted `axis` ([hi, lo, hi] at
    "high", hi at "default"): the partner of split's data layout."""
    hi = round_to_tf32(b)
    if PARTS[canonical(precision)] == 1:
        return hi
    return torch.cat([hi, round_to_tf32(b - hi), hi], dim=axis)


def contract(kind: str, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain contraction of `kind` (see KINDS), exact in FP32 unless
    cuBLAS's TF32 switch is on."""
    if _kind(kind) == "dft":
        return torch.matmul(x, table)
    if kind == "analysis":
        return torch.einsum("jmn,...jmr->...mnr", table, x)
    return torch.einsum("jmn,...mnr->...jmr", table, x)


def product_reference(x: torch.Tensor, kind: str, table_x: torch.Tensor,
                      precision) -> torch.Tensor:
    """Plain PyTorch version of `product`, on any device: x split along its
    contracted axis, then one exact product against `split_table`'s layout
    of the table."""
    mode = _split_mode(precision)
    xs = split_reference(x.contiguous(), DATA_AXIS[_kind(kind)], mode)
    return contract(kind, table_x, xs)


# ---------------------------------------------------------------------------
# The kernel's table layout and launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedTable:
    """A constant table split and laid out for csrc/tf32_product.cu: per
    group (one m of a Legendre table, the whole of a DFT table) a K x N
    product, K the contracted axis, N the output's. `data` is (G, parts,
    Kpad/8, Npad/8, 2, 8, 4) float32: the parts (hi, and lo at "high") zero-
    padded to Kpad x Npad, each 8 x 8 block of (K, N) stored as the tensor
    cores' two 16-byte core matrices of 8 columns x 4 k. `nz` (G,) int32 is
    each group's first index with a nonzero entry: of N for "analysis", of K
    for "synthesis" (the triangle n < m is zero), 0 for "dft"."""

    kind: str
    mode: str
    data: torch.Tensor
    nz: torch.Tensor
    G: int
    K: int
    N: int
    Kpad: int
    Npad: int


def _groups(b: torch.Tensor, kind: str) -> torch.Tensor:
    """The table as (G, K, N): one product of K terms for N outputs a group."""
    if kind == "dft":
        return b[None]
    if kind == "analysis":
        return b.permute(1, 0, 2)          # Pw (j, m, n) -> (m, j, n)
    return b.permute(1, 2, 0)              # P (j, m, n) -> (m, n, j)


def _first_nonzero(nonzero: torch.Tensor) -> torch.Tensor:
    """Per row of a (G, L) boolean, the index of its first True, L if none."""
    L = nonzero.shape[1]
    idx = torch.arange(L, dtype=torch.int64).expand_as(nonzero)
    return torch.where(nonzero, idx, L).min(dim=1).values.to(torch.int32)


def pack_table(b: torch.Tensor, kind: str, precision, device=None) -> PackedTable:
    """The float32 table `b` of a product of `kind` (as the transforms keep
    it: dft (K, N), Pw (j, m, n), P (j, m, n)) split into hi (and lo) and
    laid out for the kernel, on `device` (default: b's)."""
    mode = _split_mode(precision)
    if b.dtype != torch.float32:
        raise TypeError(f"pack_table: expected float32, got {b.dtype}")
    t = _groups(b.cpu(), _kind(kind))
    G, K, N = t.shape
    hi = round_to_tf32(t)
    parts = [hi, round_to_tf32(t - hi)] if TABLE_PARTS[mode] == 2 else [hi]
    Kpad, Npad = -(-K // TILE_K) * TILE_K, -(-N // TILE_COLS) * TILE_COLS
    padded = torch.zeros(G, len(parts), Kpad, Npad, dtype=torch.float32)
    padded[:, :, :K, :N] = torch.stack(parts, dim=1)
    data = (padded.reshape(G, len(parts), Kpad // 8, 2, 4, Npad // 8, 8)
            .permute(0, 1, 2, 5, 3, 6, 4).contiguous())
    if kind == "analysis":
        nz = _first_nonzero((t != 0).any(dim=1))
    elif kind == "synthesis":
        nz = _first_nonzero((t != 0).any(dim=2))
    else:
        nz = torch.zeros(G, dtype=torch.int32)
    device = b.device if device is None else device
    return PackedTable(kind, mode, data.to(device), nz.to(device), G, K, N, Kpad, Npad)


def table_for(b: torch.Tensor, kind: str, precision, device) -> object:
    """The split table a product at `precision` takes on `device`: packed
    for the kernel on a CUDA device, split_table's layout elsewhere. b is
    float32 on the CPU."""
    if torch.device(device).type == "cuda":
        return pack_table(b, kind, precision, device)
    return split_table(b, TABLE_AXIS[_kind(kind)], precision).to(device)


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """csrc/tf32_product.cu's launch: grid (column tiles, row tiles,
    groups) of THREADS threads with smem_bytes of dynamic shared memory."""

    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int


def product_plan(rows: int, Npad: int, G: int, parts: int) -> ProductPlan:
    """The launch for `rows` rows of x against G groups of Npad table
    columns with `parts` table parts; ValueError past the grid's limits."""
    if parts not in (1, 2):
        raise ValueError(f"product_plan: parts must be 1 or 2, got {parts}")
    if rows < 1 or G < 1 or Npad < TILE_COLS or Npad % TILE_COLS:
        raise ValueError(f"product_plan: rows={rows}, Npad={Npad}, G={G}")
    grid = (Npad // TILE_COLS, -(-rows // TILE_ROWS), G)
    if grid[1] > MAX_GRID or grid[2] > MAX_GRID:
        raise ValueError(f"product_plan: grid {grid} past {MAX_GRID} row tiles or "
                         "groups: split the batch")
    smem = 4 * STAGES * (parts * TILE_K * TILE_COLS + TILE_ROWS * (TILE_K + 4)) \
        + 2 * TILE_ROWS * 8
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"product_plan: {smem} bytes of shared memory")
    return ProductPlan(grid, THREADS, smem)


def _two_level(shape, stride):
    """The leading axes as (B, sb, I, si): the last axis of size > 1 as I,
    the others merged into B with one stride; None if they do not merge."""
    dims = [(n, s) for n, s in zip(shape, stride) if n != 1]
    if not dims:
        return 1, 0, 1, 0
    I, si = dims[-1]
    B, sb = 1, 0
    for n, s in reversed(dims[:-1]):
        if B == 1:
            B, sb = n, s
        elif s == sb * B:
            B *= n
        else:
            return None
    return B, sb, I, si


@dataclasses.dataclass(frozen=True)
class LaunchArgs:
    """What the wrapper passes the C entry for one product."""

    out_shape: tuple
    rows: int
    I: int
    R: int
    x_strides: tuple      # b, i, r, contraction, group (floats)
    out_strides: tuple    # b, i, r, column, group
    skip: int             # 0 none, 1 column tiles, 2 contraction tiles
    load: int             # 0 one value a thread along k, 1 along (k, r), 2 16-byte rows
    plan: ProductPlan | None      # None: no rows, nothing to launch


def launch_args(x: torch.Tensor, kind: str, table: PackedTable) -> LaunchArgs:
    """Check x against the packed table of a product of `kind` and work out
    the launch: rows, strides, how x is loaded, the plan. Raises TypeError
    or ValueError on what the kernel does not take. Reads shapes, strides
    and the data pointer only."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_product: expected float32 x, got {x.dtype}")
    if not isinstance(table, PackedTable):
        raise TypeError("tf32_product: the table must be a PackedTable (pack_table)")
    kind, shape, st = _kind(kind), tuple(x.shape), x.stride()
    if table.kind != kind:
        raise ValueError(f"tf32_product: a {table.kind!r} table for a {kind!r} product")
    nd = 1 if kind == "dft" else 3
    if len(shape) < nd:
        raise ValueError(f"tf32_product: x of shape {shape} for a {kind!r} product")
    lead, tail = shape[:-nd], shape[-nd:]
    if kind == "dft":
        want, R = (table.K,), 1
        xs = (0, st[-1], 0)                            # r, contraction, group
        out_tail = (table.N,)
    elif kind == "analysis":
        want, R = (table.K, table.G, 2), 2
        xs = (st[-1], st[-3], st[-2])
        out_tail = (table.G, table.N, 2)
    else:
        want, R = (table.G, table.K, 2), 2
        xs = (st[-1], st[-2], st[-3])
        out_tail = (table.N, table.G, 2)
    if tail != want:
        raise ValueError(f"tf32_product: x's last axes {tail} do not fit the table "
                         f"({kind!r}: {want})")
    rows_of = _two_level(lead, st[:len(lead)])
    if rows_of is None:
        raise ValueError(f"tf32_product: x's leading axes {lead} with strides "
                         f"{st[:len(lead)]} merge into no two strides")
    B, sxb, I, sxi = rows_of
    out_shape = lead + out_tail
    # the output is made contiguous: its strides follow from its shape
    ostrides = [1] * len(out_shape)
    for d in range(len(out_shape) - 2, -1, -1):
        ostrides[d] = ostrides[d + 1] * out_shape[d + 1]
    o_lead = _two_level(lead, ostrides[:len(lead)])
    _, sob, _, soi = o_lead
    if kind == "dft":
        os_ = (0, 1, 0)                                 # r, column, group
    elif kind == "analysis":
        os_ = (1, 2, 2 * table.N)
    else:
        os_ = (1, 2 * table.G, 2)
    load = 0
    if (kind == "dft" and xs[1] == 1 and table.K % 4 == 0 and x.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in (sxb, sxi))):
        load = 2
    elif R == 2 and xs[0] == 1:
        load = 1
    rows = B * I * R
    plan = product_plan(rows, table.Npad, table.G, TABLE_PARTS[table.mode]) if rows else None
    return LaunchArgs(out_shape, rows, I, R, (sxb, sxi) + xs, (sob, soi) + os_,
                      {"dft": 0, "analysis": 1, "synthesis": 2}[kind], load, plan)


@functools.cache
def _product_lib():
    from isca_tpu_torch import _build

    lib = _build.load("tf32_product")
    lib.tf32_product_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.tf32_product_f32.restype = ctypes.c_int
    lib.tf32_product_error_string.argtypes = [ctypes.c_int]
    lib.tf32_product_error_string.restype = ctypes.c_char_p
    lib.tf32_product_plan.argtypes = [ctypes.c_void_p]
    lib.tf32_product_plan.restype = None
    got = (ctypes.c_int * 7)()
    lib.tf32_product_plan(got)
    mine = [TILE_ROWS, TILE_COLS, TILE_K, STAGES, THREADS,
            product_plan(1, TILE_COLS, 1, 1).smem_bytes,
            product_plan(1, TILE_COLS, 1, 2).smem_bytes]
    if list(got) != mine:
        raise RuntimeError(f"tf32_product: the kernel's plan {list(got)} is not the "
                           f"wrapper's {mine}")
    return lib


def product(x: torch.Tensor, kind: str, table_x, precision) -> torch.Tensor:
    """A transform product of `kind` (KINDS) at "high" or "default": on a
    CUDA tensor one launch of csrc/tf32_product.cu against the PackedTable
    `table_x`; on a CPU tensor product_reference against split_table's
    layout `table_x`.

    On CUDA x must be float32 with leading axes that merge into two strides
    and its last axes those of the table; anything else raises. Each kernel
    launch adds one to `product.launches`.
    """
    mode = _split_mode(precision)
    nd = 1 if _kind(kind) == "dft" else 3
    if x.device.type == "cpu":
        if isinstance(table_x, PackedTable):
            raise TypeError("product: a CPU tensor takes split_table's layout, "
                            "not a PackedTable")
        return product_reference(x, kind, table_x, mode)
    if x.device.type != "cuda":
        raise ValueError(f"product: unsupported device {x.device}")
    if x.dim() > nd and _two_level(x.shape[:-nd], x.stride()[:-nd]) is None:
        x = x.contiguous()       # leading axes that two strides cannot address
    args = launch_args(x, kind, table_x)
    if table_x.mode != mode:
        raise ValueError(f"product: a table packed for {table_x.mode!r} at {mode!r}")
    if table_x.data.device != x.device:
        raise ValueError(f"product: x on {x.device}, the table on {table_x.data.device}")
    out = torch.empty(args.out_shape, dtype=torch.float32, device=x.device)
    if args.rows == 0:
        return out
    lib = _product_lib()
    strides = (ctypes.c_longlong * 10)(*args.x_strides, *args.out_strides)
    t = table_x
    rc = lib.tf32_product_f32(
        x.data_ptr(), out.data_ptr(), t.data.data_ptr(), t.nz.data_ptr(), args.rows, args.I,
        args.R, ctypes.addressof(strides), t.K, t.N, t.Kpad, t.Npad, t.G,
        TABLE_PARTS[mode], args.skip, args.load, args.plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32_product launch failed: CUDA error {rc} "
                           f"({lib.tf32_product_error_string(rc).decode()})")
    product.launches += 1
    return out


product.launches = 0


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

