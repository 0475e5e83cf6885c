"""The "high" and "default" transform products of isca_tpu_torch
(spectral/precision.py `product`, the csrc/tf32_product.cu kernel's wrapper)
on the CPU, where the wrapper runs its plain version.

* `product` on CPU tensors equals the path it replaced bit for bit (the
  data operand split by `split`, then the exact einsum against
  `split_table`'s layout), for the four products of the transforms, both
  modes, on one device and with a mesh rank's block of the tables.
* The kernel's table layout (`pack_table`) unpacks to the table's TF32
  parts, zero-padded, with each group's first nonzero index.
* An emulation of the kernel's addressing (the strides `launch_args` hands
  it, the packed table, the skipped triangle) equals the plain version
  within the FP32 rounding of its sums, for contiguous inputs, a
  non-contiguous latitude band, a chain of the batch, a mesh rank's tables
  and contracted lengths that are no multiple of 8.
* Skipping the triangle (n < m is zero in P and Pw) leaves the product of
  finite inputs unchanged to the bit; a NaN of x facing only zeros of the
  table reaches the plain product and not the skipping one.
* The wrapper's checks that need no card, the launch plan from T21 to T213
  on 1, 2 and 4 ranks, and that every product of a Held-Suarez step at
  "high" is one the kernel takes.
"""

import numpy as np
import pytest
import torch

from isca_tpu_torch.models.dry import HeldSuarezConfig, HeldSuarezModel
from isca_tpu_torch.dycore.primitive import PrimitiveConfig
from isca_tpu_torch.parallel.mesh import Mesh
from isca_tpu_torch.spectral import precision as prec
from isca_tpu_torch.spectral import transforms as ttr

U = 2.0 ** -24
TINY = 2.0 ** -126
MODES = ("high", "default")
# the four products: (kind, table attribute, data shape after the batch)
PRODUCTS = {"dft_analysis": ("dft", "dft_ana"), "dft_synthesis": ("dft", "dft_syn"),
            "legendre_analysis": ("analysis", "Pw"),
            "legendre_synthesis": ("synthesis", "P")}
LEAD = (3, 4)   # fields x levels


def unpack_table(t):
    """The packed table's parts as (G, parts, K, N): the inverse of
    pack_table's layout."""
    G, P = t.data.shape[:2]
    full = t.data.permute(0, 1, 2, 4, 6, 3, 5).reshape(G, P, t.Kpad, t.Npad)
    return full[:, :, :t.K, :t.N]


def data_shape(T, name):
    M1, N1 = T.spec_shape[0], T.num_spherical + 1
    nlat = T.lats.shape[0]       # the rank's band on a mesh
    return {"dft_analysis": (nlat, T.nlon), "dft_synthesis": (nlat, 2 * (T.num_fourier + 1)),
            "legendre_analysis": (T.nlat, M1, 2), "legendre_synthesis": (M1, N1, 2)}[name]


def old_path(x, kind, table, mode):
    """The products as spectral/transforms.py computed them before the
    kernel: split, then the exact product of the einsum's own form."""
    axis = prec.DATA_AXIS[kind]
    xs = prec.split(x.contiguous(), axis, mode)
    with prec.tf32_products(xs.device):
        if kind == "dft":
            return torch.matmul(xs, table)
        if kind == "analysis":
            return torch.einsum("jmn,...jmr->...mnr", table, xs)
        return torch.einsum("jmn,...mnr->...jmr", table, xs)


def transforms(res, mode, ranks=1, rank=0):
    mesh = None
    if ranks > 1:
        mesh = Mesh(group=None, rank=rank, size=ranks, backend="gloo",
                    device=torch.device("cpu"))
    return ttr.make_transforms(res, dtype=torch.float32, device="cpu", precision=mode,
                               mesh=mesh)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ranks,rank", [(1, 0), (2, 1)])
def test_product_equals_the_replaced_path_bit_for_bit(mode, ranks, rank):
    T = transforms("T21", mode, ranks, rank)
    rng = np.random.default_rng(1)
    for name, (kind, table) in PRODUCTS.items():
        x = torch.as_tensor(rng.standard_normal(LEAD + data_shape(T, name)).astype(np.float32))
        got = prec.product(x, kind, getattr(T, table + "_x"), mode)
        want = old_path(x, kind, getattr(T, table + "_x"), mode)
        assert got.dtype == torch.float32 and torch.equal(got, want), name
        # the transforms' own call goes the same way
        assert torch.equal(ttr._product(T, x, kind, getattr(T, table), getattr(T, table + "_x")),
                           want), name


@pytest.mark.parametrize("mode", MODES)
def test_pack_table_layout(mode):
    T = transforms("T21", "highest")
    for name, (kind, table) in PRODUCTS.items():
        b = getattr(T, table)
        t = prec.pack_table(b, kind, mode)
        g = prec._groups(b, kind)
        G, K, N = g.shape
        assert (t.G, t.K, t.N) == (G, K, N) and t.mode == mode and t.kind == kind
        assert t.Kpad % prec.TILE_K == 0 and 0 <= t.Kpad - K < prec.TILE_K
        assert t.Npad % prec.TILE_COLS == 0 and 0 <= t.Npad - N < prec.TILE_COLS
        assert t.data.shape == (G, prec.TABLE_PARTS[mode], t.Kpad // 8, t.Npad // 8, 2, 8, 4)
        hi = prec.round_to_tf32(g)
        parts = unpack_table(t)
        assert torch.equal(parts[:, 0], hi)
        if mode == "high":
            assert torch.equal(parts[:, 1], prec.round_to_tf32(g - hi))
        # the padding is zero: the unpacked block holds all that is not
        assert int((t.data != 0).sum()) == int((parts != 0).sum())
        # 8 consecutive k of a table column sit as two 16-byte rows 128 bytes apart
        k, n = 8 + 5, 9
        blk = t.data[0, 0, k // 8, n // 8]
        assert blk[(k % 8) // 4, n % 8, k % 4] == hi[0, k, n]
        nz = t.nz.tolist()
        if kind == "dft":
            assert nz == [0] * G
        for m, first in enumerate(nz):
            along = g[m].abs().sum(dim=0) if kind == "analysis" else g[m].abs().sum(dim=1)
            if kind != "dft":
                assert float(along[:first].sum()) == 0.0
                assert first == along.shape[0] or along[first] != 0
        if kind != "dft":     # the triangle: m's first nonzero n is m
            assert nz[:T.num_fourier_true + 1] == list(range(T.num_fourier_true + 1)), name


def emulate(x, kind, t, skip=True):
    """csrc/tf32_product.cu's result in float64: x read through the strides
    that launch_args hands the kernel, split, multiplied by the packed
    table's parts, the skipped tiles left out, and written through the
    output's strides (every entry once)."""
    a = prec.launch_args(x, kind, t)
    sxb, sxi, sxr, sxk, sxg = a.x_strides
    sob, soi, sor, soc, sog = a.out_strides
    B = a.rows // (a.I * a.R)
    X = torch.as_strided(x, (B, a.I, a.R, t.G, t.K), (sxb, sxi, sxr, sxg, sxk),
                         x.storage_offset())
    X = X.permute(3, 0, 1, 2, 4).reshape(t.G, a.rows, t.K)
    hi = prec.round_to_tf32(X)
    lo = prec.round_to_tf32(X - hi)
    nz = t.nz.long()
    if skip and a.skip == 2:      # contraction tiles wholly below nz
        k = torch.arange(t.K)
        below = k[None, :] < (nz[:, None] // prec.TILE_K) * prec.TILE_K
        hi = hi.masked_fill(below[:, None, :], 0.0)
        lo = lo.masked_fill(below[:, None, :], 0.0)
    parts = unpack_table(t).double()
    res = hi.double() @ parts[:, 0]
    if parts.shape[1] == 2:
        res = res + (hi.double() @ parts[:, 1] + lo.double() @ parts[:, 0])
    if skip and a.skip == 1:      # column tiles wholly below nz
        c = torch.arange(t.N)
        zero = (c[None, :] // prec.TILE_COLS + 1) * prec.TILE_COLS <= nz[:, None]
        res = res.masked_fill(zero[:, None, :], 0.0)
    out = torch.full(a.out_shape, float("nan"), dtype=torch.float64)
    view = torch.as_strided(out, (B, a.I, a.R, t.G, t.N), (sob, soi, sor, sog, soc))
    view.copy_(res.reshape(t.G, B, a.I, a.R, t.N).permute(1, 2, 3, 0, 4))
    return out


def check_emulation(x, kind, table, mode, name):
    t = prec.pack_table(table, kind, mode)
    got = emulate(x, kind, t)
    plain_table = prec.split_table(table, prec.TABLE_AXIS[kind], mode)
    want = prec.product_reference(x, kind, plain_table, mode).double()
    assert got.shape == want.shape, name
    assert not got.isnan().any(), f"{name}: an output entry was never written"
    mag = prec.contract(kind, plain_table.abs().double(),
                        prec.split(x.contiguous(), prec.DATA_AXIS[kind], mode).abs().double())
    k = prec.PARTS[mode] * (x.shape[prec.DATA_AXIS[kind]])
    bound = k * U * mag + k * TINY * float(x.abs().max())
    assert ((got - want).abs() <= bound).all(), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("res", ["T21", "T42"])
def test_kernel_addressing_emulated(mode, res):
    T = transforms(res, "highest")
    rng = np.random.default_rng(2)
    for name, (kind, table) in PRODUCTS.items():
        shape = LEAD + data_shape(T, name)
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        check_emulation(x, kind, getattr(T, table), mode, name)
    # a latitude band cut from a larger grid, and a chain of the batch: not contiguous
    g = torch.as_tensor(rng.standard_normal((5, 4, T.nlat, T.nlon)).astype(np.float32))
    check_emulation(g[1:4, :, 4:T.nlat // 2], "dft", T.dft_ana, mode, "band")
    check_emulation(g[2, 1:3], "dft", T.dft_ana, mode, "levels of one field")
    F = torch.as_tensor(rng.standard_normal((4, 3, T.nlat, T.num_fourier + 1, 2))
                        .astype(np.float32))
    check_emulation(F.transpose(0, 1), "analysis", T.Pw, mode, "levels first")


@pytest.mark.parametrize("ranks", [2, 4])
def test_kernel_addressing_emulated_on_mesh_blocks(ranks):
    rng = np.random.default_rng(3)
    for rank in range(ranks):
        T = transforms("T21", "highest", ranks, rank)
        for name, (kind, table) in PRODUCTS.items():
            x = torch.as_tensor(rng.standard_normal(LEAD + data_shape(T, name))
                                .astype(np.float32))
            check_emulation(x, kind, getattr(T, table), "high", f"{name} rank {rank}")


def test_ragged_contraction_lengths():
    """K and n no multiple of 8: the DFT synthesis' 2(M+1) = 44 and the
    Legendre synthesis' N+2 = 23 at T21, and an odd truncation."""
    T = ttr.make_transforms(13, dtype=torch.float32, device="cpu", nlon=40, nlat=22)
    rng = np.random.default_rng(4)
    M1, N1 = T.num_fourier + 1, T.num_spherical + 1
    assert (2 * M1) % 8 and N1 % 8 and T.nlat % 8
    for kind, table, shape in (("dft", T.dft_syn, (T.nlat, 2 * M1)),
                               ("synthesis", T.P, (M1, N1, 2)),
                               ("analysis", T.Pw, (T.nlat, M1, 2))):
        x = torch.as_tensor(rng.standard_normal((2, 3) + shape).astype(np.float32))
        for mode in MODES:
            check_emulation(x, kind, table, mode, kind)


def test_triangle_skip_exact_for_finite_inputs_and_the_nan_case():
    """At T85 the analysis skips the first 64-column tile of m >= 64 and the
    synthesis the 32-term contraction tiles below m. With finite x the
    skipping product equals the full one to the bit (only exact zeros are
    left out). A NaN of x at m = 85 meets only zeros of the table there:
    the full product turns those outputs to NaN, the skipping one to 0
    (analysis) or leaves them finite (synthesis): the one difference, as
    csrc/tf32_product.cu's note states."""
    T = transforms("T85", "highest")
    rng = np.random.default_rng(5)
    M1, N1 = T.num_fourier + 1, T.num_spherical + 1
    for kind, table, shape in (("analysis", T.Pw, (T.nlat, M1, 2)),
                               ("synthesis", T.P, (M1, N1, 2))):
        t = prec.pack_table(table, kind, "high")
        assert int(t.nz[M1 - 1]) == M1 - 1
        x = torch.as_tensor(rng.standard_normal((1,) + shape).astype(np.float32))
        assert torch.equal(emulate(x, kind, t), emulate(x, kind, t, skip=False)), kind
        xn = x.clone()
        if kind == "analysis":
            xn[0, 0, M1 - 1, 0] = float("nan")    # j = 0, m = 85: n < 64 skipped
            full = emulate(xn, kind, t, skip=False)[0, M1 - 1, :64, 0]
            skipped = emulate(xn, kind, t)[0, M1 - 1, :64, 0]
            assert (skipped == 0).all()
        else:
            xn[0, M1 - 1, 0, 0] = float("nan")    # m = 85, n = 0: k < 64 skipped
            full = emulate(xn, kind, t, skip=False)[0, :, M1 - 1, 0]
            skipped = emulate(xn, kind, t)[0, :, M1 - 1, 0]
        assert full.isnan().all() and not skipped.isnan().any(), kind


def test_wrapper_checks_without_a_card():
    T = transforms("T21", "highest")
    t = prec.pack_table(T.Pw, "analysis", "high")
    x = torch.zeros(2, T.nlat, T.num_fourier + 1, 2)
    with pytest.raises(ValueError, match="exact"):
        prec.product(x, "analysis", t, "highest")
    with pytest.raises(ValueError, match="kind"):
        prec.product(x, "legendre", t, "high")
    with pytest.raises(TypeError, match="PackedTable"):
        prec.product(x, "analysis", t, "high")             # a CPU tensor, a packed table
    with pytest.raises(ValueError, match="device"):
        prec.product(x.to("meta"), "analysis", t, "high")
    with pytest.raises(TypeError, match="float32"):
        prec.launch_args(x.double(), "analysis", t)
    with pytest.raises(TypeError, match="PackedTable"):
        prec.launch_args(x, "analysis", prec.split_table(T.Pw, 0, "high"))
    with pytest.raises(ValueError, match="table"):
        prec.launch_args(x, "synthesis", t)
    with pytest.raises(ValueError, match="fit"):
        prec.launch_args(x[:, :-1], "analysis", t)
    with pytest.raises(ValueError, match="merge"):
        prec.launch_args(torch.zeros(4, 6, 5, T.nlat, T.num_fourier + 1, 2)[:, 1:4, 1:4],
                         "analysis", t)
    with pytest.raises(TypeError, match="float32"):
        prec.pack_table(T.Pw.double(), "analysis", "high")
    with pytest.raises(ValueError, match="exact"):
        prec.pack_table(T.Pw, "analysis", "highest")
    # x in the layout the kernel loads 16 bytes at a time, or value by value
    dft = prec.pack_table(T.dft_ana, "dft", "default")
    assert prec.launch_args(torch.zeros(3, T.nlat, T.nlon), "dft", dft).load == 2
    assert prec.launch_args(torch.zeros(3, T.nlon, T.nlat).transpose(1, 2), "dft",
                            dft).load == 0
    assert prec.launch_args(x, "analysis", t).load == 1
    assert prec.launch_args(x[:0], "analysis", t).plan is None     # no rows: no launch


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("res,L", [("T21", 8), ("T42", 25), ("T85", 25), ("T170", 30),
                                   ("T213", 30)])
def test_launch_plan(res, L, ranks):
    trunc, nlon, nlat = ttr.RESOLUTIONS[res]
    M1 = trunc + 1 + (-(trunc + 1)) % ranks
    N1 = trunc + 2
    batch = 6 * L                         # the dycore batches up to 6 fields
    for mode in MODES:
        parts = prec.TABLE_PARTS[mode]
        for rows, N, G in ((batch * nlat // ranks, 2 * M1, 1), (batch * nlat // ranks, nlon, 1),
                           (2 * batch, N1, M1 // ranks), (2 * batch, nlat, M1 // ranks)):
            Npad = -(-N // prec.TILE_COLS) * prec.TILE_COLS
            plan = prec.product_plan(rows, Npad, G, parts)
            assert plan.grid == (Npad // prec.TILE_COLS, -(-rows // 64), G)
            assert plan.threads == 2 * prec.TILE_COLS and plan.smem_bytes <= 227 * 1024
            assert plan.smem_bytes == (4 * prec.STAGES * (parts * 32 * prec.TILE_COLS + 64 * 36)
                                       + 1024)
    with pytest.raises(ValueError, match="grid"):
        prec.product_plan(64 * 65536, prec.TILE_COLS, 1, 2)
    with pytest.raises(ValueError, match="parts"):
        prec.product_plan(64, 64, 1, 3)


def test_every_product_of_a_held_suarez_step_is_one_the_kernel_takes(monkeypatch):
    """The data operands of a leapfrog HS T21L8 step at "high", as the
    model hands them to `product`: each is one launch_args accepts against
    the packed table (no copy of x on the way); the step makes 6 products
    (the first step, from the initial state, 24)."""
    model = HeldSuarezModel(HeldSuarezConfig(core=PrimitiveConfig(
        resolution="T21", num_levels=8, dtype=torch.float32, transform_precision="high")),
        device="cpu")
    T = model.core.T
    state = model.step(model.initial_state(), first=True)
    packed = {id(getattr(T, a + "_x")): (kind, prec.pack_table(getattr(T, a), kind, "high"))
              for kind, a in PRODUCTS.values()}
    seen = []
    real = prec.product

    def spy(x, kind, table_x, precision):
        k, t = packed[id(table_x)]
        assert k == kind
        a = prec.launch_args(x, kind, t)
        seen.append((kind, tuple(x.shape), a.load))
        return real(x, kind, table_x, precision)

    monkeypatch.setattr(prec, "product", spy)
    model.step(state)
    assert len(seen) == 6, seen
    assert {k for k, _, _ in seen} == {"dft", "analysis", "synthesis"}


def test_step_timing_needs_a_card():
    """isca_tpu_torch/utils/step_timing.py times steps on the card and
    refuses to time anything elsewhere."""
    from isca_tpu_torch.utils import step_timing

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would time it")
    with pytest.raises(SystemExit, match="no CUDA"):
        step_timing.main(["--precision", "high"])


def test_ablation_copies_still_apply():
    """isca_tpu_torch/utils/tf32_product_ablation.py times copies of the
    kernel with one part taken out: each text it replaces is in the kernel
    once, and without a card it refuses to run."""
    from isca_tpu_torch import _build
    from isca_tpu_torch.utils import tf32_product_ablation as ablation

    src = (_build.CSRC / "tf32_product.cu").read_text()
    assert set(ablation.ABLATIONS) >= {"kernel", "no_tensor_cores", "no_x_loads"}
    for subs in ablation.ABLATIONS.values():
        for old in subs:
            assert src.count(old) == 1, old
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA"):
            ablation.main([])
