"""The height-sharded solver (``localexpstereo_tpu_torch.parallel.volume``)
against the port's single-device engine, bit for bit, and the port's
single-device solve of the same problem against the JAX engine's.

The JAX package's test problem (``tests/test_volume_sharding.py``: 37 x 48,
12 disparities, layers [3, 5]) over three gloo ranks on the CPU, one
launch with a timeout for every sharded solve of the file; it runs in the
background while this process solves the single-device references and
the JAX solve."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu_torch.config import PARAMS_GF
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine
from localexpstereo_tpu_torch.parallel import collectives
from localexpstereo_tpu_torch.parallel.volume import (ShardedVolumeSolver,
                                                      build_vol_shards,
                                                      shard_rows)

torch.set_num_threads(1)

TIMEOUT_S = 300
N_RANKS = 3
LAYERS = [3, 5]
#: (interp, greedy sweeps, graph-cut sweeps) of the solves.
CASES = ((1, 1, 2), (0, 1, 1), (2, 1, 1))


def _problem(h=37, w=48, nd=12, seed=3):
    r = np.random.default_rng(seed)
    img = (r.random((h, w, 3)) * 255).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = np.clip(0.05 * xs - 0.02 * ys + 4.0, 0, nd - 1)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.3, 1.0).astype(np.float32)
    vol += r.random(vol.shape, np.float32) * 0.05
    return img, vol, nd


def _make(cls, interp, **kw):
    img, vol, nd = _problem()
    params = PARAMS_GF.replace(windR=4, lambda_=0.5, th_col=0.5)
    s = cls(img, img, params, max_disp=float(nd - 1), vol0=vol, vol1=vol,
            seed=7, device="cpu", interp=interp, **kw)
    for i, us in enumerate(LAYERS):
        s.add_layer(us, engine.LAYER0_PROPOSERS if i == 0
                    else engine.COARSE_PROPOSERS)
    return s


class _Energies:
    def __init__(self, audit):
        self.audit, self.rows = audit, []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.rows.append(float(self.audit(solver.data, solver.cfg,
                                          labeling_m, cost_m, mode)[0]))


def _solve(s, pm, gc):
    lab, raw = s.run(iterations=gc, pm_iterations=pm)
    return {"lab": lab, "raw": raw, "cost": s._state[0][1]}


def _hshard_rank(rank, device):
    out = []
    for interp, pm, gc in CASES:
        s = _make(ShardedVolumeSolver, interp)
        res = _solve(s, pm, gc)
        res.update(vol=s.data.vol, hq=s.hq, halo=s.halo)
        out.append(res)
    return out


@pytest.fixture(scope="module")
def launched():
    """The sharded solves, started in the background."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(collectives.launch, _hshard_rank,
                         ["cpu"] * N_RANKS, timeout_s=TIMEOUT_S)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(launched):
    out = []
    for interp, pm, gc in CASES:
        s = _make(engine.LocalExpansionSolver, interp)
        rec = _Energies(engine.energy_audit)
        s.set_evaluator(rec)
        res = _solve(s, pm, gc)
        out.append(dict(res, solver=s, energies=rec.rows))
    return out


@pytest.fixture(scope="module")
def hsolves(refs, launched):
    return refs, launched.result(timeout=TIMEOUT_S)


def test_single_device_solve_agrees_with_jax(refs):
    """The port's single-device solve of this problem (1 + 2) against the
    JAX engine's, on the JAX side's energy carried across: every energy
    row within the engine tests' trajectory tolerance, 0.002 |E| + 1e-3."""
    img, vol, nd = _problem()
    js = jeng.LocalExpansionSolver(
        img, img, J_PARAMS.replace(windR=4, lambda_=0.5, th_col=0.5),
        max_disp=float(nd - 1), vol0=vol, vol1=vol, seed=7)
    for i, us in enumerate(LAYERS):
        js.add_layer(us, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    # The port's min-cut knobs at these window sizes (16, 16); the JAX
    # engine's CPU defaults differ.
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    jrec = _Energies(jeng.energy_audit)
    js.set_evaluator(jrec)
    js.run(iterations=CASES[0][2], view_modes=(0,),
           pm_iterations=CASES[0][1])
    ts = _make(engine.LocalExpansionSolver, 1)
    ts.data, ts.cfg = tenergy.energy_from_numpy(js.data, js.cfg,
                                                device="cpu")
    trec = _Energies(engine.energy_audit)
    ts.set_evaluator(trec)
    ts.run(iterations=CASES[0][2], pm_iterations=CASES[0][1])
    assert len(trec.rows) == len(jrec.rows) == 4
    for got, want in zip(trec.rows, jrec.rows):
        assert abs(got - want) <= 0.002 * abs(want) + 1e-3, (trec.rows,
                                                             jrec.rows)
    # The port's own energy build gives the same trajectory as the one
    # carried across.
    np.testing.assert_allclose(refs[0]["energies"], trec.rows, rtol=1e-6)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"interp{c[0]}" for c in CASES])
def test_hsharded_solve_is_bitwise(hsolves, case):
    """Labels, the raw output and the cost state of every rank equal the
    single-device solve's bit for bit (interp 1 at 1 + 2; 0 and 2 at
    1 + 1)."""
    refs, outs = hsolves
    for ranks in outs:
        got = ranks[case]
        for k in ("lab", "raw", "cost"):
            np.testing.assert_array_equal(got[k], refs[case][k].numpy())


def test_shard_height_and_rows(hsolves):
    """Each rank holds its hq + 2 halo rows that the padded volume has:
    those rows of the single-device volume, bit for bit (the uint8 range
    of the whole volume)."""
    refs, outs = hsolves
    whole = refs[0]["solver"].data.vol
    vol_pad = refs[0]["solver"].cfg.vol_pad
    h = refs[0]["solver"].cfg.height
    for r, ranks in enumerate(outs):
        got = ranks[0]
        hq, halo = got["hq"], got["halo"]
        assert hq == -(-h // N_RANKS) and halo == 8 * max(LAYERS) + 2
        rows = shard_rows(r, hq, halo, vol_pad, whole.shape[2])
        assert rows.start == max(r * hq - halo + vol_pad, 0)
        assert rows.stop == min((r + 1) * hq + halo + vol_pad,
                                whole.shape[2])
        assert got["vol"].shape[2] == len(rows) <= hq + 2 * halo
        np.testing.assert_array_equal(
            got["vol"], build_vol_shards(whole, r, hq, halo,
                                         vol_pad).numpy())
        np.testing.assert_array_equal(got["vol"],
                                      whole[:, :, rows.start:rows.stop])
