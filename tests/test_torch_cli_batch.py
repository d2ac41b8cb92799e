"""The port's batch command line (``cli/batch.py``) against the JAX
package's (mirrors ``tests/test_cli_batch.py``).

Three MiddV3 directories written here (two 16 x 40 scenes and one 16 x
56, 8 disparities, ``im0.acrt`` only) are solved by the port's command on
the CPU (1 greedy + 1 graph-cut sweep, no warm-up): the grouping by shape,
the per-dataset artifacts and ``batch_summary.json``'s keys. The JAX
command solves the two same-shape scenes (one shape group, one set of
compiled programs; on one device of its mesh, its min-cut knobs set to
the port's (16, 16)): each one's energy trajectory (0.002·|E| + 1e-3 per
log row) and bad rates of ``disp0.pfm`` (0.5 pt) against the port's, and
the summary's group against the port's. Then the name
disambiguation, ``-targetParent`` and MiddV2 mode on directories from
``utils/synthetic.write_v2_scene``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from localexpstereo_tpu.cli import batch as jbatch
from localexpstereo_tpu.models import energy as jenergy
from localexpstereo_tpu_torch.cli import batch as tbatch
from localexpstereo_tpu_torch.utils import acrt, pfm, png, synthetic

torch.set_num_threads(1)

H, W, ND = 16, 40, 8
SCHEDULE = ["-iterations", "1", "-pmIterations", "1", "-warmup", "0"]
SUMMARY_KEYS = {"shape", "datasets", "batch", "waves", "wall_s",
                "amortized_s_per_frame"}


def _make_scene(root, name, h, w, nd, seed):
    rng = np.random.default_rng(seed)
    target = root / name
    target.mkdir()
    im = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    png.write(str(target / "im0.png"), im)
    png.write(str(target / "im1.png"), im)
    (target / "calib.txt").write_text(f"width={w}\nheight={h}\nndisp={nd}\n")
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    truth = np.clip(0.05 * xs + 0.02 * ys + 2.0, 1, nd - 2)
    d = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (rng.random(vol.shape) * 0.02).astype(np.float32)
    acrt.write_acrt(str(target / "im0.acrt"), vol)
    pfm.write_pfm(str(target / "disp0GT.pfm"), truth)
    return str(target), truth


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch")
    scenes = {"s1": _make_scene(root, "s1", H, W, ND, 1),
              "s2": _make_scene(root, "s2", H, W, ND, 2),
              "s3": _make_scene(root, "s3", H, W + 16, ND, 3)}
    dirs = [d for d, _ in scenes.values()]
    build = jenergy.build_energy

    def knobs(*args, **kwargs):
        data, cfg = build(*args, **kwargs)
        return data, dataclasses.replace(cfg, gc_rounds=16, gc_sweeps=16)
    one = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenergy, "build_energy", knobs)
        mp.setattr(jax, "devices", lambda *args: one)
        jsum = jbatch.run_batch(jbatch.parse_args(
            ["-mode", "MiddV3", "-targetDirs", *dirs[:2], "-outputDir",
             str(root / "jax"), "-platform", "cpu", *SCHEDULE]))
    assert tbatch.main(["-mode", "MiddV3", "-targetDirs", *dirs,
                        "-outputDir", str(root / "port"), "-device", "cpu",
                        *SCHEDULE]) == 0
    tsum = json.loads((root / "port" / "batch_summary.json").read_text())
    return root, scenes, jsum, tsum


def _log(path):
    rows = path.read_text().strip().split("\n")
    assert rows[0].split("\t") == ["Time", "Eng", "Data", "Smooth", "all",
                                   "nonocc"]
    return [[float(v) for v in row.split("\t")] for row in rows[1:]]


def test_parse_args_reference_style():
    ns = tbatch.parse_args(["-mode", "MiddV3", "-targetDirs", "/a", "/b",
                            "-doDual", "1", "-volPrecision", "float32",
                            "-device", "cpu"])
    assert ns.targetDirs == ["/a", "/b"] and ns.doDual == 1
    assert ns.volPrecision == "float32" and ns.device == "cpu"
    assert tbatch.parse_args([]).device == "cuda"


def test_groups_and_summary(runs):
    _, _, jsum, tsum = runs
    assert tsum["n_devices"] == 1
    by_shape = {tuple(g["shape"]): g for g in tsum["groups"]}
    assert sorted(by_shape) == [(H, W, ND), (H, W + 16, ND)]
    assert by_shape[(H, W, ND)]["datasets"] == ["s1", "s2"]
    assert by_shape[(H, W + 16, ND)]["datasets"] == ["s3"]
    (jg,) = jsum["groups"]
    g = by_shape[(H, W, ND)]
    assert SUMMARY_KEYS <= set(jg)
    assert (g["shape"], g["datasets"], g["batch"], g["waves"]) == (
        jg["shape"], jg["datasets"], jg["batch"], jg["waves"])
    for g in tsum["groups"]:
        assert SUMMARY_KEYS <= set(g)
        assert g["waves"] == g["batch"]           # one device: one a wave
        assert g["amortized_s_per_frame"] == pytest.approx(
            g["wall_s"] / g["batch"])
        assert len(g["load_s"]) == len(g["prefetch_wait_s"]) == g["batch"]


def test_artifacts_and_parity_with_jax(runs):
    root, scenes, _, _ = runs
    for name, (_, truth) in scenes.items():
        out, jout = root / "port" / name, root / "jax" / name
        assert {"disp0.pfm", "time.txt", "debug"} <= {
            p.name for p in out.iterdir()}
        assert not (out / "disp0raw.pfm").exists()
        assert float((out / "time.txt").read_text()) > 0.0
        assert (out / "debug" / "result0D00.png").exists()
        got = _log(out / "debug" / "log_output.txt")
        disp = pfm.read_pfm(str(out / "disp0.pfm"))
        assert len(got) == 3
        assert disp.shape == truth.shape and np.isfinite(disp).all()
        if name == "s3":
            continue
        want = _log(jout / "debug" / "log_output.txt")
        assert len(want) == 3
        for g, w in zip(got, want):
            assert abs(g[1] - w[1]) <= 0.002 * abs(w[1]) + 1e-3, (got, want)
        jdisp = pfm.read_pfm(str(jout / "disp0.pfm"))
        for t in (0.5, 1.0):
            bad = (np.abs(disp - truth) > t).mean() * 100
            jbad = (np.abs(jdisp - truth) > t).mean() * 100
            assert abs(bad - jbad) <= 0.5, (name, t, bad, jbad)


def test_dedupe_names():
    entries = [{"dir": "/d/trainingH/Adirondack", "name": "Adirondack"},
               {"dir": "/d/trainingQ/Adirondack", "name": "Adirondack"},
               {"dir": "/d/trainingH/ArtL", "name": "ArtL"},
               {"dir": "/e/trainingH/ArtL/", "name": "ArtL"}]
    tbatch._dedupe_names(entries)
    names = [e["name"] for e in entries]
    assert names == ["trainingH_Adirondack", "trainingQ_Adirondack",
                     "trainingH_ArtL", "trainingH_ArtL_1"]
    jentries = [dict(e, name=e["dir"].rstrip("/").split("/")[-1])
                for e in entries]
    jbatch._dedupe_names(jentries)
    assert [e["name"] for e in jentries] == names


def test_target_parent_and_midv2(tmp_path):
    """-targetParent finds the V2 directories (imL.png) and skips the
    rest; both are one shape group; -doDual 1 writes disp0raw.pfm."""
    parent = tmp_path / "set"
    parent.mkdir()
    for i, name in enumerate(("b", "a")):
        synthetic.write_v2_scene(parent / name, 32, 48, 8, seed=i)
    (parent / "notes").mkdir()
    assert tbatch._expand_parent(str(parent)) == [str(parent / "a"),
                                                  str(parent / "b")]
    out = tmp_path / "out"
    summary = tbatch.run_batch(tbatch.parse_args(
        ["-mode", "MiddV2", "-targetParent", str(parent), "-outputDir",
         str(out), "-doDual", "1", "-iterations", "0", "-pmIterations", "1",
         "-warmup", "0", "-device", "cpu"]))
    (group,) = summary["groups"]
    assert group["datasets"] == ["a", "b"] and group["batch"] == 2
    assert group["load_s"] is None
    for name in ("a", "b"):
        for f in ("disp0.pfm", "disp0raw.pfm"):
            disp = pfm.read_pfm(str(out / name / f))
            assert disp.shape == (32, 48) and np.isfinite(disp).all()
        assert len(_log(out / name / "debug" / "log_output.txt")) == 3
