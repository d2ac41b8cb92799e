"""The port's command line against the JAX package's, and its host-side
codecs against the JAX copies and OpenCV.

One synthetic MiddV3 directory (40 x 72, 12 disparities; PNG images,
``calib.txt``, ``im0.acrt`` and ``disp0GT.pfm``) is solved once by the JAX
CLI on the CPU and twice by the port's CLI with ``-device cpu``: once on
the "auto" unary route and once on the "dma" route (the fused kernel's
plain version). Layers {1%, 3%, 9%} of the width = [1, 2, 6], 1 greedy + 2
graph-cut sweeps. The JAX side's min-cut knobs are set to the port's
(16, 16) for these windows; its CPU defaults differ. Tolerances: the
energy trajectory within 0.002·|E| + 1e-3 per row of ``log_output.txt``,
bad rates of ``disp0.pfm`` within 0.5 pt. A written MiddV2 directory is
solved with ``-doDual 1`` by both (``test_cli_midv2_do_dual_matches_jax``).
"""
import dataclasses
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from localexpstereo_tpu.cli import main as jcli
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.utils import acrt as jacrt
from localexpstereo_tpu.utils import calib as jcalib
from localexpstereo_tpu.utils import pfm as jpfm
from localexpstereo_tpu_torch.cli import main as tcli
from localexpstereo_tpu_torch.utils import acrt, calib, pfm, png, synthetic

H, W, ND = 40, 72, 12
SCHEDULE = ["-pmIterations", "1", "-iterations", "2", "-seed", "0"]


def _write_scene(target):
    r = np.random.default_rng(3)
    target.mkdir()
    im = (r.random((H, W, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(target / "im0.png"), im)
    cv2.imwrite(str(target / "im1.png"), im)
    with open(target / "calib.txt", "w") as f:
        f.write(f"cam0=[100 0 36; 0 100 20; 0 0 1]\nwidth={W}\n"
                f"height={H}\nndisp={ND}\n")
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    truth = np.clip(0.05 * xs + 0.03 * ys + 2.0, 1, ND - 2)
    d = np.arange(ND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.02).astype(np.float32)
    acrt.write_acrt(str(target / "im0.acrt"), vol)
    pfm.write_pfm(str(target / "disp0GT.pfm"), truth)
    return truth


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    truth = _write_scene(root / "scene")
    scene = str(root / "scene")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        assert jcli.main(["-mode", "MiddV3", "-targetDir", scene,
                          "-outputDir", str(root / "jax"), "-platform",
                          "cpu", "-warmup", "0", *SCHEDULE]) == 0
    # The "auto" run takes the default warm-up (a throwaway solve first),
    # which must leave the timed solve unchanged; the "dma" run skips it
    # and writes the live preview files (-show 1).
    for backend, extra in (("auto", ["-warmup", "1"]),
                           ("dma", ["-warmup", "0", "-show", "1"])):
        assert tcli.main(["-mode", "MiddV3", "-targetDir", scene,
                          "-outputDir", str(root / backend), "-device",
                          "cpu", "-unaryBackend", backend, *extra,
                          *SCHEDULE]) == 0
    return root, truth


def _log(out):
    rows = open(out / "debug" / "log_output.txt").read().split("\n")
    assert rows[0] == "Time\tEng\tData\tSmooth\tall\tnonocc"
    return np.array([[float(v) for v in r.split("\t")] for r in rows[1:]
                     if r])


def _bad(disp, truth, thresh):
    return float((np.abs(disp - truth) > thresh).mean() * 100)


@pytest.mark.parametrize("backend", ["auto", "dma"])
def test_cli_energy_log_matches_jax(runs, backend):
    root, _ = runs
    want, got = _log(root / "jax"), _log(root / backend)
    assert got.shape == want.shape == (1 + 1 + 2, 6)
    for g, w in zip(got[:, 1], want[:, 1]):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got[:, 1], want[:, 1])
    # The log's bad rates (columns all, nonocc) agree too.
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=0.5)
    assert all(b <= a for a, b in zip(got[1:, 1], got[2:, 1]))


@pytest.mark.parametrize("backend", ["auto", "dma"])
def test_cli_disparity_matches_jax(runs, backend):
    root, truth = runs
    want = jpfm.read_pfm(str(root / "jax" / "disp0.pfm"))
    got = pfm.read_pfm(str(root / backend / "disp0.pfm"))
    assert got.shape == want.shape == (H, W)
    assert np.isfinite(got).all()
    for thresh in (0.5, 1.0):
        assert abs(_bad(got, truth, thresh) - _bad(want, truth, thresh)) \
            <= 0.5
    assert _bad(got, truth, 1.0) < 10.0
    assert float(open(root / backend / "time.txt").read()) > 0
    names = sorted(os.listdir(root / backend / "debug"))
    assert "result0D03.png" in names and "result0E03.png" in names
    assert png.read_gray(str(root / backend / "debug" / "result0D03.png")
                         ).shape == (H, W)


def test_show_writes_the_last_sweep_live(runs):
    """-show 1 keeps live_D.png / live_E.png at the last sweep's disparity
    and error images (all pixels count as non-occluded here, so the error
    image has no occlusion shade)."""
    debug = runs[0] / "dma" / "debug"
    assert not os.path.exists(runs[0] / "auto" / "debug" / "live_D.png")
    for kind in ("D", "E"):
        np.testing.assert_array_equal(
            png.read_gray(str(debug / f"live_{kind}.png")),
            png.read_gray(str(debug / f"result0{kind}03.png")))


def test_dma_and_auto_routes_agree_on_cpu(runs):
    """On the CPU the dma route runs the kernel's plain version, the same
    arithmetic as the auto route."""
    root, _ = runs
    np.testing.assert_array_equal(_log(root / "dma")[:, 1:],
                                  _log(root / "auto")[:, 1:])


# ------------------------------------------------------------ the flags ----

def test_flags_and_spellings():
    opt = tcli.parse_args(["-mode", "MiddV3", "-filterRadious", "12",
                           "--smooth_weight", "2", "-unaryBackend", "blk",
                           "-device", "cpu", "-volPrecision", "float32"])
    assert (opt.mode, opt.filter_radius, opt.resolve_smooth_weight(),
            opt.unary_backend, opt.device, opt.vol_precision) == \
        ("MiddV3", 12, 2.0, "auto", "cpu", "float32")
    opt = tcli.parse_args(["--mode", "MiddV3", "--filterRadius", "8",
                           "-unaryBackend", "dma"])
    assert (opt.filter_radius, opt.resolve_smooth_weight(),
            opt.unary_backend, opt.device) == (8, 0.5, "dma", "cuda")
    assert tcli.v3_layers(1436) == [14, 43, 129] == jcli.v3_layers(1436)
    assert tcli.parse_args(["-mode", "MiddV3", "-fuseSeeds", "3"]
                           ).fuse_seeds == 3
    for d in ("x/trainingQ/a", "x/trainingF/a", "x/trainingH/a"):
        assert tcli.v3_error_threshold(d) == jcli.v3_error_threshold(d)


@pytest.mark.parametrize("flags,item", [
    (["-laneFriendly", "1"], "laneFriendly"),
])
def test_unported_flags_fail_loudly(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.parse_args(["-mode", "MiddV3", *flags])


@pytest.mark.parametrize("flags,field,value", [
    (["-doDual", "1"], "do_dual", True),
    (["-fuseSeeds", "3", "-doDual", "1"], "do_dual", True),
    (["-volPrecision", "bfloat16"], "vol_precision", "bfloat16"),
    (["-mode", "MiddV2"], "mode", "MiddV2"),
    (["-volume", "mccnn"], "volume", "mccnn"),
])
def test_ported_flags_are_taken(flags, field, value):
    """The flags the port once refused (the two views, A10; the bfloat16
    volume; the V2 mode, A11; the MC-CNN volume, A13) are taken now."""
    opt = tcli.parse_args(["-mode", "MiddV3", *flags])
    assert getattr(opt, field) == value
    assert tcli.parse_args(["-mode", "MiddV3"]).do_dual is False


def test_usage_without_mode(capsys):
    assert tcli.main(["-device", "cpu"]) == 1
    assert "-mode [MiddV2, MiddV3]" in capsys.readouterr().out


def test_device_cuda_without_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-mode", "MiddV3", "-targetDir", str(tmp_path)])


def test_cli_imports_no_jax(tmp_path):
    """The command line imports no jax, JAX package or OpenCV, also when it
    runs the MiddV2 mode (one graph-cut sweep of a 32 x 48 scene, with jax
    made unimportable)."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        from localexpstereo_tpu_torch.cli import main
        from localexpstereo_tpu_torch.utils import synthetic
        synthetic.write_v2_scene("scene", 32, 48, 12)
        assert main.main(["-mode", "MiddV2", "-targetDir", "scene",
                          "-outputDir", "out", "-device", "cpu",
                          "-pmIterations", "0", "-iterations", "1",
                          "-warmup", "0"]) == 0
        bad = [m for m in sys.modules if sys.modules[m] is not None and (
            m == "jax" or m.startswith(("jax.", "localexpstereo_tpu.",
                                        "cv2")))]
        assert not bad, bad
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr
    assert (tmp_path / "out" / "disp0.pfm").exists()


def test_cli_mccnn_volume_matches_jax(tmp_path):
    """-mode MiddV3 -volume mccnn through both command lines, 1 greedy + 1
    graph-cut sweep, on a 40 x 72 MiddV3 directory without any .acrt: a
    rendered stereo pair (``synthetic.v2_scene``, 12 disparities) as
    im0/im1.png, calib.txt and disp0GT.pfm. Each computes the left volume
    with the bundled MC-CNN weights (the port on the CPU) and recovers the
    right one; the JAX side's min-cut knobs are set to the port's (16,
    16). The energy log within 0.002·|E| + 1e-3 per row, its bad rates
    within 0.5 pt, disp0.pfm within 0.5 px at 99 % of the pixels."""
    scene = tmp_path / "scene"
    scene.mkdir()
    im_l, im_r, truth, _ = synthetic.v2_scene(H, W, ND, seed=5)
    png.write(str(scene / "im0.png"), im_l)
    png.write(str(scene / "im1.png"), im_r)
    with open(scene / "calib.txt", "w") as f:
        f.write(f"cam0=[100 0 36; 0 100 20; 0 0 1]\nwidth={W}\n"
                f"height={H}\nndisp={ND}\n")
    pfm.write_pfm(str(scene / "disp0GT.pfm"), truth)
    schedule = ["-volume", "mccnn", "-pmIterations", "1", "-iterations",
                "1", "-seed", "0", "-warmup", "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        assert jcli.main(["-mode", "MiddV3", "-targetDir", str(scene),
                          "-outputDir", str(tmp_path / "jax"), "-platform",
                          "cpu", *schedule]) == 0
    assert tcli.main(["-mode", "MiddV3", "-targetDir", str(scene),
                      "-outputDir", str(tmp_path / "port"), "-device", "cpu",
                      *schedule]) == 0
    want, got = _log(tmp_path / "jax"), _log(tmp_path / "port")
    assert got.shape == want.shape == (1 + 1 + 1, 6)
    for g, w in zip(got[:, 1], want[:, 1]):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=0.5)
    d_got = pfm.read_pfm(str(tmp_path / "port" / "disp0.pfm"))
    d_want = jpfm.read_pfm(str(tmp_path / "jax" / "disp0.pfm"))
    assert d_got.shape == (H, W) and np.isfinite(d_got).all()
    assert (np.abs(d_got - d_want) < 0.5).mean() >= 0.99
    assert _bad(d_got, truth, 1.0) < 50.0


V2_H, V2_W, V2_ND = 48, 64, 16


def test_cli_midv2_do_dual_matches_jax(tmp_path):
    """-mode MiddV2 -doDual 1 through both command lines on a written V2
    directory (``synthetic.write_v2_scene``: 48 x 64, 16 disparities,
    imL/imR.png, groundtruth.png at scale 4, nonocc.png, info.txt), the
    V2 layers {5, 15, 25}, 1 greedy + 1 graph-cut sweep, the JAX side's
    min-cut knobs set to the port's (16, 16): 1 + 1 + 1 + 1 log rows each,
    energies within 0.002·|E| + 1e-3, the log's bad rates (threshold 0.5
    on the quarter-pixel ground truth) within 0.5 pt; disp0.pfm and
    disp0raw.pfm within 0.5 px of the JAX ones at 99 % of the pixels; the
    consistency images as the JAX command line writes them."""
    truth = synthetic.write_v2_scene(str(tmp_path / "scene"), V2_H, V2_W,
                                     V2_ND, seed=3)
    scene = str(tmp_path / "scene")
    schedule = ["-doDual", "1", "-pmIterations", "1", "-iterations", "1",
                "-seed", "0", "-warmup", "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        assert jcli.main(["-mode", "MiddV2", "-targetDir", scene,
                          "-outputDir", str(tmp_path / "jax"), "-platform",
                          "cpu", *schedule]) == 0
    assert tcli.main(["-mode", "MiddV2", "-targetDir", scene, "-outputDir",
                      str(tmp_path / "port"), "-device", "cpu",
                      *schedule]) == 0
    want, got = _log(tmp_path / "jax"), _log(tmp_path / "port")
    assert got.shape == want.shape == (1 + 1 + 1 + 1, 6)
    for g, w in zip(got[:, 1], want[:, 1]):
        assert abs(g - w) <= 0.002 * abs(w) + 1e-3, (got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=0.5)
    for name in ("disp0.pfm", "disp0raw.pfm"):
        d_got = pfm.read_pfm(str(tmp_path / "port" / name))
        d_want = jpfm.read_pfm(str(tmp_path / "jax" / name))
        assert d_got.shape == (V2_H, V2_W) and np.isfinite(d_got).all()
        assert (np.abs(d_got - d_want) < 0.5).mean() >= 0.99
        assert _bad(d_got, truth, 2.0) < 50.0
    assert float(open(tmp_path / "port" / "time.txt").read()) > 0
    names = {n for n in os.listdir(tmp_path / "port" / "debug") if "C" in n}
    assert names == {n for n in os.listdir(tmp_path / "jax" / "debug")
                     if "C" in n} == {f"result{mode}C{index:02d}.png"
                                      for mode in (0, 1) for index in (1, 2)}


# ------------------------------------------------------------ the codecs ---

def _images(seed):
    r = np.random.default_rng(seed)
    smooth = np.cumsum(r.integers(-3, 4, (23, 41, 4)), 1) + 128
    smooth = np.clip(smooth, 0, 255).astype(np.uint8)
    noise = r.integers(0, 256, (23, 41, 4), dtype=np.uint8)
    for img in (smooth, noise):
        yield "gray", img[..., 0]
        yield "bgr", img[..., :3]
        yield "bgra", img


def _pil_save(path, img, kind):
    if kind == "gray":
        Image.fromarray(img, "L").save(path)
    elif kind == "bgr":
        Image.fromarray(np.ascontiguousarray(img[..., ::-1]), "RGB").save(path)
    else:
        Image.fromarray(np.ascontiguousarray(img[..., [2, 1, 0, 3]]),
                        "RGBA").save(path)


def _encode_all_filters(path, img):
    """PNG of ``img`` (BGR) whose rows cycle through the five filter types,
    so the reader sees every one (OpenCV and PIL pick theirs per row)."""
    rgb = img[..., ::-1] if img.ndim == 3 else img[..., None]
    h, w, ch = rgb.shape
    rows = rgb.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        kind = y % 5
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("writer", ["cv2", "pil", "all_filters"])
def test_png_reader_matches_opencv(tmp_path, writer):
    for i, (kind, img) in enumerate(_images(1)):
        path = str(tmp_path / f"{i}.png")
        if writer == "cv2":
            cv2.imwrite(path, img)
        elif writer == "pil":
            _pil_save(path, img, kind)
        else:
            _encode_all_filters(path, img)
        for ours, flag in ((png.read_color, cv2.IMREAD_COLOR),
                           (png.read_gray, cv2.IMREAD_GRAYSCALE)):
            want = cv2.imread(path, flag)
            got = ours(path)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{kind}")


def test_png_writer_matches_opencv(tmp_path):
    for kind, img in _images(2):
        if kind == "bgra":
            continue
        ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        png.write(ours, img)
        cv2.imwrite(theirs, img)
        flag = cv2.IMREAD_GRAYSCALE if kind == "gray" else cv2.IMREAD_COLOR
        np.testing.assert_array_equal(cv2.imread(ours, flag),
                                      cv2.imread(theirs, flag))
        np.testing.assert_array_equal(cv2.imread(ours, flag), img)


def test_pfm_acrt_calib_round_trips(tmp_path):
    r = np.random.default_rng(4)
    for shape in ((7, 9), (5, 6, 3)):
        img = r.normal(size=shape).astype(np.float32)
        pfm.write_pfm(str(tmp_path / "a.pfm"), img)
        jpfm.write_pfm(str(tmp_path / "b.pfm"), img)
        assert open(tmp_path / "a.pfm", "rb").read() == \
            open(tmp_path / "b.pfm", "rb").read()
        np.testing.assert_array_equal(pfm.read_pfm(str(tmp_path / "a.pfm")),
                                      img)
    vol = r.random((5, 6, 9)).astype(np.float32)
    acrt.write_acrt(str(tmp_path / "v.acrt"), vol)
    got = acrt.read_acrt(str(tmp_path / "v.acrt"), 5, 6, 9)
    np.testing.assert_array_equal(got, jacrt.read_acrt(
        str(tmp_path / "v.acrt"), 5, 6, 9))
    for mode in (0, 1):
        np.testing.assert_array_equal(acrt.fill_out_of_view(got, mode),
                                      jacrt.fill_out_of_view(got, mode))
    np.testing.assert_array_equal(acrt.convert_volume_l2r(got),
                                  jacrt.convert_volume_l2r(got))
    with open(tmp_path / "calib.txt", "w") as f:
        f.write("cam0=[1 0 2; 0 1 3; 0 0 1]\ndoffs=1.5\nbaseline=193.0\n"
                "width=9\nheight=6\nndisp=5\nvmin=1\nvmax=4\n")
    assert dataclasses.asdict(calib.parse_calib(str(tmp_path / "calib.txt"))) \
        == dataclasses.asdict(jcalib.parse_calib(str(tmp_path / "calib.txt")))
    with open(tmp_path / "info.txt", "w") as f:
        f.write("4 60\n")
    assert calib.parse_info(str(tmp_path / "info.txt")) == \
        jcalib.parse_info(str(tmp_path / "info.txt")) == (4, 60)
