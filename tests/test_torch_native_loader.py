"""The port's threaded ``.acrt`` loader (``native/loader.cpp``, built at
first use) against the JAX package's numpy codec: the read with each
out-of-view fill, the fill where d exceeds the width, the fused L->R
recovery, bitwise; the read's errors; and the build's (no fallback hides
a missing compiler or a failed build)."""
import subprocess

import numpy as np
import pytest

from localexpstereo_tpu.utils import acrt as jacrt
from localexpstereo_tpu_torch import native


def _vol(d=7, h=11, w=23, seed=0):
    return np.random.default_rng(seed).random((d, h, w)).astype(np.float32)


@pytest.mark.parametrize("mode", [-1, 0, 1])
def test_read_acrt_fill_matches_numpy(tmp_path, mode):
    vol = _vol()
    path = str(tmp_path / "v.acrt")
    jacrt.write_acrt(path, vol)
    got = native.read_acrt_fill(path, *vol.shape, fill_mode=mode, threads=3)
    want = jacrt.read_acrt(path, *vol.shape)
    if mode >= 0:
        want = jacrt.fill_out_of_view(want, mode)
    np.testing.assert_array_equal(got, want)


def test_read_acrt_fill_large_d_exceeds_width(tmp_path):
    vol = _vol(d=30, h=5, w=9, seed=1)
    path = str(tmp_path / "v.acrt")
    jacrt.write_acrt(path, vol)
    for mode in (0, 1):
        got = native.read_acrt_fill(path, *vol.shape, fill_mode=mode)
        np.testing.assert_array_equal(got, jacrt.fill_out_of_view(vol, mode))


@pytest.mark.parametrize("shape", [(16, 6, 12), (30, 5, 9)])
def test_convert_l2r_fill_matches_numpy(shape):
    vol = _vol(*shape, seed=2)
    got = native.convert_l2r_fill(vol, threads=4)
    want = jacrt.fill_out_of_view(jacrt.convert_volume_l2r(vol), 1)
    np.testing.assert_array_equal(got, want)


def test_read_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_acrt_fill(str(tmp_path / "missing.acrt"), 2, 2, 2)
    short = str(tmp_path / "short.acrt")
    with open(short, "wb") as f:
        f.write(b"\x00" * 8)
    with pytest.raises(OSError, match="short read"):
        native.read_acrt_fill(short, 4, 4, 4)


def test_build_is_cached_by_source():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.build() == path == native.output()


def test_build_failures_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))

    def missing(*args, **kwargs):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.build()
