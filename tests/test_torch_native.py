"""isca_tpu_torch's native library (native/fastio.cpp, built with g++ at
first use), mirroring tests/test_native.py, and against isca_tpu's."""

import pathlib

import numpy as np
import pytest

import isca_tpu_torch.native as native
from isca_tpu import native as jnative
from isca_tpu_torch.native import combine_tiles, native_available, ns_clock, pack_f32, rss_kb
from isca_tpu_torch.utils.clocks import Clocks


def test_native_builds_from_the_ports_own_source():
    assert native_available()
    lib = native.build_library()
    assert lib.parent == pathlib.Path(native.__file__).resolve().parent.parent / "_build" / "native"
    assert native.SRC.parent == pathlib.Path(native.__file__).resolve().parent
    assert native.SRC.name == "fastio.cpp"


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int broken( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build_library(src=bad, out_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_combine_tiles():
    full = np.random.rand(64, 8, 16).astype(np.float32)
    tiles = [full[0:16], full[16:40], full[40:64]]
    out = combine_tiles(tiles, [0, 16, 40], 64)
    np.testing.assert_array_equal(out, full)
    np.testing.assert_array_equal(out, jnative.combine_tiles(tiles, [0, 16, 40], 64))


def test_combine_bounds_check():
    with pytest.raises(ValueError):
        combine_tiles([np.zeros((8, 4), np.float32)], [60], 64)


def test_clock_monotonic():
    a = ns_clock()
    b = ns_clock()
    assert b >= a


def test_rss():
    assert rss_kb() > 1000  # at least 1 MB resident


def test_clocks_summary():
    c = Clocks()
    with c.clock("outer"):
        with c.clock("inner"):
            sum(range(1000))
    s = c.summary()
    assert "outer" in s and "inner" in s and "rss" in s
    assert "rss: -" not in s          # measured by the native library


def test_pack_f32():
    a = np.random.rand(6, 9, 12).astype(np.float32)
    for view in (a, a[1:5, ::2, 3::3], a[:, 4:5, :]):
        out = pack_f32(view)
        assert out.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(out, view)
    with pytest.raises(ValueError):
        pack_f32(a.astype(np.float64))
