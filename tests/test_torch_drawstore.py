"""The port's `.stkr` draw store: the JAX package's store cases on the
port's copy (built with g++ at first use), and files read across the two
packages in both directions with equal arrays."""

import os
import shutil

import numpy as np
import pytest

from stark_tpu import drawstore as rstore
from stark_tpu_torch import _build
from stark_tpu_torch.drawstore import DrawStore, read_draws, truncate_draws


def test_roundtrip(tmp_path):
    path = str(tmp_path / "draws.stkr")
    rng = np.random.default_rng(0)
    b1 = rng.standard_normal((4, 10, 3)).astype(np.float32)  # (chains, n, d)
    b2 = rng.standard_normal((4, 7, 3)).astype(np.float32)
    with DrawStore(path, chains=4, dim=3) as ds:
        ds.append(b1)
        ds.append(b2)
        ds.flush()
        assert len(ds) == 17
    draws, chains, dim = read_draws(path)
    assert (chains, dim) == (4, 3)
    assert draws.shape == (17, 4, 3)
    # draw-major on disk == transpose of the (chains, n, d) blocks
    np.testing.assert_array_equal(draws[:10], np.transpose(b1, (1, 0, 2)))
    np.testing.assert_array_equal(draws[10:], np.transpose(b2, (1, 0, 2)))


def test_draw_major_append_skips_the_transpose(tmp_path):
    path = str(tmp_path / "dm.stkr")
    block = np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3)  # (n, chains, d)
    with DrawStore(path, chains=4, dim=3) as ds:
        ds.append(block, draw_major=True)
        with pytest.raises(ValueError, match="draw-major"):
            ds.append(np.zeros((4, 5, 3), np.float32), draw_major=True)
    np.testing.assert_array_equal(read_draws(path, mmap=False)[0], block)


def test_many_async_appends(tmp_path):
    path = str(tmp_path / "many.stkr")
    with DrawStore(path, chains=2, dim=2) as ds:
        for i in range(50):
            ds.append(np.full((2, 5, 2), i, np.float32))  # returns at once
    draws, _, _ = read_draws(path)
    assert draws.shape == (250, 2, 2)
    for i in range(50):
        np.testing.assert_array_equal(draws[5 * i: 5 * (i + 1)], np.full((5, 2, 2), i, np.float32))


def test_reopen_appends_instead_of_truncating(tmp_path):
    path = str(tmp_path / "resume.stkr")
    b1 = np.ones((2, 5, 3), np.float32)
    with DrawStore(path, chains=2, dim=3) as ds:
        ds.append(b1)
    with DrawStore(path, chains=2, dim=3) as ds:
        assert len(ds) == 5
        ds.append(2.0 * b1)
    draws, _, _ = read_draws(path)
    assert draws.shape == (10, 2, 3)
    np.testing.assert_array_equal(draws[:5], np.ones((5, 2, 3), np.float32))
    np.testing.assert_array_equal(draws[5:], 2 * np.ones((5, 2, 3), np.float32))
    # a mismatched header is an error, not a truncation
    with pytest.raises(OSError):
        DrawStore(path, chains=4, dim=3)
    assert read_draws(path)[0].shape == (10, 2, 3)


def test_shape_validation(tmp_path):
    with DrawStore(str(tmp_path / "v.stkr"), chains=2, dim=3) as ds:
        with pytest.raises(ValueError):
            ds.append(np.zeros((5, 4), np.float32))
        with pytest.raises(ValueError):
            ds.append(np.zeros((7, 7, 7), np.float32))


def _torn_copy(path, tmp_path, cut_bytes):
    torn = str(tmp_path / "torn.stkr")
    shutil.copyfile(path, torn)
    os.truncate(torn, os.path.getsize(torn) - cut_bytes)
    return torn


@pytest.mark.parametrize("mmap", [True, False])
def test_read_tolerates_torn_tail(tmp_path, mmap):
    path = str(tmp_path / "t.stkr")
    block = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    with DrawStore(path, chains=2, dim=3) as ds:
        ds.append(block)
    torn = _torn_copy(path, tmp_path, cut_bytes=5)  # tear into row 5
    draws, chains, dim = read_draws(torn, mmap=mmap)
    assert (chains, dim) == (2, 3)
    assert draws.shape == (5, 2, 3)
    np.testing.assert_array_equal(draws, np.transpose(block, (1, 0, 2))[:5])


@pytest.mark.parametrize("mmap", [True, False])
def test_read_torn_inside_first_row(tmp_path, mmap):
    path = str(tmp_path / "t0.stkr")
    with DrawStore(path, chains=2, dim=3) as ds:
        ds.append(np.ones((2, 1, 3), np.float32))
    draws, _, _ = read_draws(_torn_copy(path, tmp_path, cut_bytes=4), mmap=mmap)
    assert draws.shape == (0, 2, 3)
    assert draws.dtype == np.float32


def test_read_opens_read_only(tmp_path):
    path = str(tmp_path / "ro.stkr")
    with DrawStore(path, chains=2, dim=3) as ds:
        ds.append(np.ones((2, 4, 3), np.float32))
    draws, _, _ = read_draws(path, mmap=True)
    assert isinstance(draws, np.memmap)
    assert draws.mode == "r"
    with pytest.raises((ValueError, OSError)):
        draws[0, 0, 0] = 42.0


def test_truncate_drops_rows_and_never_extends(tmp_path):
    path = str(tmp_path / "tr.stkr")
    block = np.arange(2 * 9 * 3, dtype=np.float32).reshape(2, 9, 3)
    with DrawStore(path, chains=2, dim=3) as ds:
        ds.append(block)
    truncate_draws(path, 4)
    np.testing.assert_array_equal(read_draws(path)[0], np.transpose(block, (1, 0, 2))[:4])
    size = os.path.getsize(path)
    truncate_draws(path, 100)
    assert os.path.getsize(path) == size
    with pytest.raises(ValueError, match="not a DrawStore"):
        with open(str(tmp_path / "x"), "wb") as f:
            f.write(b"garbage" * 10)
        read_draws(str(tmp_path / "x"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_read_across_packages(tmp_path, writer):
    path = str(tmp_path / f"{writer}.stkr")
    rng = np.random.default_rng(1)
    blocks = [rng.standard_normal((3, n, 4)).astype(np.float32) for n in (6, 1, 9)]
    make = DrawStore if writer == "port" else rstore.DrawStore
    with make(path, 3, 4) as ds:
        for b in blocks:
            ds.append(b)
    want = np.concatenate([b.transpose(1, 0, 2) for b in blocks])
    for read in (read_draws, rstore.read_draws):
        for mmap in (True, False):
            draws, chains, dim = read(path, mmap=mmap)
            assert (chains, dim) == (3, 4)
            np.testing.assert_array_equal(draws, want)
    # and either package appends to the other's file
    other = rstore.DrawStore if writer == "port" else DrawStore
    with other(path, 3, 4) as ds:
        assert len(ds) == 16
        ds.append(blocks[1])
    np.testing.assert_array_equal(read_draws(path)[0][16:], blocks[1].transpose(1, 0, 2))


def test_host_library_builds_into_the_build_directory():
    lib = _build.host_library("drawstore")
    assert lib is _build.host_library("drawstore")  # loaded once per process
    out = _build._host_target("drawstore")
    assert out.parent == _build.BUILD_DIR and out.exists()
    assert not list(_build.BUILD_DIR.glob(f"{out.stem}.*.tmp"))
    with pytest.raises(ValueError, match="unknown host library"):
        _build.host_library("nope")
