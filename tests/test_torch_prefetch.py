"""The port's pair prefetcher (``utils/prefetch.py``) on MiddV3 directories
written here: order, one pair ahead of the consumer, the volumes against
the JAX package's numpy codec, and a loader error raised on the
consumer's side naming the directory."""
import threading
import time

import numpy as np
import pytest

from localexpstereo_tpu.utils import acrt as jacrt
from localexpstereo_tpu_torch.utils import acrt, datasets, pfm, png, prefetch


def _scene(root, name, h=12, w=20, nd=6, seed=0, right=False):
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir()
    im = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    png.write(str(d / "im0.png"), im)
    png.write(str(d / "im1.png"), im)
    (d / "calib.txt").write_text(f"width={w}\nheight={h}\nndisp={nd}\n")
    acrt.write_acrt(str(d / "im0.acrt"),
                    rng.random((nd, h, w)).astype(np.float32))
    if right:
        acrt.write_acrt(str(d / "im1.acrt"),
                        rng.random((nd, h, w)).astype(np.float32))
    pfm.write_pfm(str(d / "disp0GT.pfm"), np.ones((h, w), np.float32))
    return str(d)


def test_order_and_volumes(tmp_path):
    dirs = [_scene(tmp_path, f"s{i}", seed=i, right=i == 1)
            for i in range(3)]
    items = list(prefetch.PairPrefetcher(dirs, load_volumes=True))
    assert [d for d, _, _, _ in items] == dirs
    for d, pair, vol_l, vol_r in items:
        nd, (h, w) = pair.ndisp, pair.im0.shape[:2]
        want_l = jacrt.fill_out_of_view(
            jacrt.read_acrt(d + "/im0.acrt", nd, h, w), 0)
        if d.endswith("s1"):
            want_r = jacrt.read_acrt(d + "/im1.acrt", nd, h, w)
        else:
            want_r = jacrt.convert_volume_l2r(want_l)
        np.testing.assert_array_equal(vol_l, want_l)
        np.testing.assert_array_equal(vol_r,
                                      jacrt.fill_out_of_view(want_r, 1))


def test_without_volumes(tmp_path):
    dirs = [_scene(tmp_path, "a")]
    (d, pair, vol_l, vol_r), = prefetch.PairPrefetcher(dirs)
    assert vol_l is None and vol_r is None and pair.im0.shape == (12, 20, 3)


def test_one_pair_ahead(tmp_path, monkeypatch):
    """While the consumer holds pair k, pair k + 1 is loaded and k + 2 is
    not."""
    dirs = [_scene(tmp_path, f"s{i}", seed=i) for i in range(4)]
    loaded = []
    lock = threading.Lock()
    real = datasets.load_data

    def load(d, ndisp=0):
        with lock:
            loaded.append(d)
        return real(d, ndisp)
    monkeypatch.setattr(datasets, "load_data", load)
    pf = prefetch.PairPrefetcher(dirs, load_volumes=True)
    for k, (d, _, _, _) in enumerate(pf):
        assert d == dirs[k]
        ahead = dirs[k + 1:k + 2]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not set(ahead) <= set(loaded):
            time.sleep(0.01)
        time.sleep(0.1)
        with lock:
            assert loaded == dirs[:k + 2], (k, loaded)
    assert len(pf.wait_s) == 4 and set(pf.load_s) == set(dirs)


def test_error_raised_on_consumer_side(tmp_path):
    good = _scene(tmp_path, "good")
    missing = str(tmp_path / "missing")
    pf = prefetch.PairPrefetcher([good, missing], load_volumes=True)
    it = iter(pf)
    assert next(it)[0] == good
    with pytest.raises(RuntimeError, match="prefetch failed for .*missing"):
        next(it)


def test_short_volume_is_an_error(tmp_path):
    d = _scene(tmp_path, "short")
    with open(d + "/im0.acrt", "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(RuntimeError, match="prefetch failed") as info:
        list(prefetch.PairPrefetcher([d], load_volumes=True))
    assert "short read" in str(info.value.__cause__)
