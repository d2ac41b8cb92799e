"""The port's fusion move against the JAX package's, on the CPU.

Module by module: the fusion tables and boundary t-links, the fusion graph
and its energy guard, the min-cut of prebuilt graphs (the plain version of
``csrc/mincut_accept.cu``) against the Pallas kernel ``mincut_accept_pallas``
in interpret mode, the per-pixel warm-start unary, one fusion color step,
``run(fuse_with=...)``, ``fuse()``, ``completion_labeling`` and the command
line's ``-fuseSeeds 2``.

The solver-level tests share one synthetic V3 scene (32 x 48, 12
disparities, layers [2, 4, 8], windR 6, 1 greedy + 1 graph-cut sweep; the
JAX side's expansion min-cut knobs set to the port's (16, 16)). The
external labeling is the JAX solve of seed 1, fed to both sides, and the
port runs on the JAX side's energy and states, carried across as numpy.
Tolerances: tables 1e-6; graph and guard rtol 1e-6, atol 1e-5; cut
energies rel 1e-4, abs 1e-3; the warm-start unary atol 2e-4 (guided
filter: float64 box sums in another order); energies per log row within
0.002·|E| + 1e-3, the trajectory tolerance of the other solver tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.cli import main as jcli
from localexpstereo_tpu.config import PARAMS_GF as J_PARAMS
from localexpstereo_tpu.models import engine as jeng
from localexpstereo_tpu.models import proposals as jprop
from localexpstereo_tpu.ops import mincut as jmc
from localexpstereo_tpu.ops import mincut_pallas as jmp
from localexpstereo_tpu.ops import pairwise as jpw
from localexpstereo_tpu_torch.cli import main as tcli
from localexpstereo_tpu_torch.config import PARAMS_GF as T_PARAMS
from localexpstereo_tpu_torch.models import energy as tenergy
from localexpstereo_tpu_torch.models import engine as teng
from localexpstereo_tpu_torch.models import proposals as tprop
from localexpstereo_tpu_torch.ops import mincut as tmc
from localexpstereo_tpu_torch.ops import mincut_cuda
from localexpstereo_tpu_torch.ops import pairwise as tpw
from localexpstereo_tpu_torch.utils import pfm, synthetic
from tests.test_fusion import _energy as _fusion_energy
from tests.test_fusion import _fusion_problem
from tests.test_mincut import _energy, _random_problem
from tests.test_torch_cli import _log, _write_scene

torch.set_num_threads(1)

LAM, TAU = 0.7, 1.0


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(got, want):
    return abs(got - want) <= 0.002 * abs(want) + 1e-3


# ------------------------------------------------------------- modules ----

@pytest.mark.parametrize("n,s", [(4, 5), (3, 8)])
def test_fusion_tables_and_tlinks_match_jax(n, s):
    rng = np.random.default_rng(n)
    *_, halo0, halo1, coeff = _fusion_problem(rng, n, s)
    coeff8 = rng.random((n, 8, s, s)).astype(np.float32)
    ox = rng.integers(-3, 10, n).astype(np.float32)
    oy = rng.integers(-3, 10, n).astype(np.float32)
    jargs = tuple(map(jnp.asarray, (halo0, halo1)))

    def vm(fn, cf):
        return jax.vmap(lambda h0, h1, c, x0, y0: fn(h0, h1, c, x0, y0, LAM,
                                                     TAU))(
            *jargs, jnp.asarray(cf), jnp.asarray(ox), jnp.asarray(oy))

    got = tpw.fusion_tables(*_t(halo0, halo1, coeff, ox, oy), LAM, TAU)
    got += tpw.fusion_boundary_tlinks(*_t(halo0, halo1, coeff8, ox, oy), LAM,
                                      TAU)
    want = vm(jpw.fusion_tables, coeff) + vm(jpw.fusion_boundary_tlinks,
                                            coeff8)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_fusion_graph_and_guard_match_jax():
    rng = np.random.default_rng(11)
    n, s = 5, 6
    terms = _fusion_problem(rng, n, s)[:6]
    for got, want in zip(tmc.build_fusion_graph(*_t(*terms)),
                         jmc.build_fusion_graph(*map(jnp.asarray, terms))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
    acc = rng.random((n, s, s)) > 0.5
    got = tmc.fusion_move_energy_delta(torch.as_tensor(acc), *_t(*terms))
    want = jmc.fusion_move_energy_delta(jnp.asarray(acc),
                                        *map(jnp.asarray, terms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("seed,n,s", [(0, 4, 6), (1, 2, 10), (2, 3, 9)])
def test_mincut_accept_matches_pallas_kernel(seed, n, s):
    """The plain version of the min-cut kernel against the Pallas kernel it
    replaces (interpret mode): equal masks, hence equal cut energies."""
    t0, t1, c00, c01, c10 = _random_problem(np.random.default_rng(seed), n,
                                            s)
    want = np.asarray(jmp.mincut_accept_pallas(
        *map(jnp.asarray, (t0, t1, c00, c01, c10)), interpret=True))
    before = mincut_cuda.solve_graph.launches
    got = mincut_cuda.mincut_accept(*_t(t0, t1, c00, c01, c10)).numpy()
    assert mincut_cuda.solve_graph.launches == before  # CPU: no kernel
    for i in range(n):
        e_got = _energy(got[i], t0[i], t1[i], c00[i], c01[i], c10[i])
        e_want = _energy(want[i], t0[i], t1[i], c00[i], c01[i], c10[i])
        assert e_got == pytest.approx(e_want, rel=1e-4, abs=1e-3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,s", [(1, 4, 5), (5, 3, 8)])
def test_fusion_accept_matches_jax(seed, n, s):
    """Fused energy <= min(all-keep, all-switch), as the JAX fusion move
    guarantees, and equal to the JAX solve's."""
    terms = _fusion_problem(np.random.default_rng(seed), n, s)[:6]
    got = mincut_cuda.fusion_accept(*_t(*terms)).numpy()
    want = np.asarray(jmc.fusion_accept(*map(jnp.asarray, terms)))
    for i in range(n):
        tables = [t[i] for t in terms]
        e_got = _fusion_energy(got[i], *tables)
        e_ends = [_fusion_energy(np.full((s, s), v), *tables)
                  for v in (False, True)]
        assert e_got <= min(e_ends) + 1e-3
        assert e_got == pytest.approx(_fusion_energy(want[i], *tables),
                                      rel=1e-4, abs=1e-3)


def test_fusion_terms_of_synthetic_problem_match_jax():
    """The fusion inputs of the kernel checks on the card
    (``synthetic.fusion_move_problem``): the port's tables and unaries
    against JAX's, and its fusion solve against the JAX one."""
    arrays, lam, tau = synthetic.fusion_move_problem(
        np.random.default_rng(8), 3, 7)
    halo0, halo1, tox, toy, coeff8, ccost, pcost = arrays
    got = mincut_cuda.fusion_terms(*_t(*arrays), lam, tau)
    jargs = [jnp.asarray(a) for a in (halo0, halo1)]
    tables = jax.vmap(lambda h0, h1, cf, x0, y0: jpw.fusion_tables(
        h0, h1, cf, x0, y0, lam, tau))(
        *jargs, jnp.asarray(coeff8[:, list(jpw.FORWARD)]), jnp.asarray(tox),
        jnp.asarray(toy))
    t0b, t1b = jax.vmap(lambda h0, h1, cf, x0, y0: jpw.fusion_boundary_tlinks(
        h0, h1, cf, x0, y0, lam, tau))(*jargs, jnp.asarray(coeff8),
                                       jnp.asarray(tox), jnp.asarray(toy))
    want = (ccost + np.asarray(t0b), pcost + np.asarray(t1b), *tables)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)
    acc = mincut_cuda.fusion_accept(*got).numpy()
    want_acc = np.asarray(jmc.fusion_accept(*map(jnp.asarray, want)))
    for i in range(3):
        e = [_fusion_energy(a[i], *[np.asarray(t)[i] for t in want])
             for a in (acc, want_acc)]
        assert e[0] == pytest.approx(e[1], rel=1e-4, abs=1e-3)
    assert 0 < acc.mean() < 1


def test_solve_graph_counts_plain_work():
    """The plain solve's per-region work counts (what the card's bound is
    computed from) leave its result unchanged and are positive."""
    t0, t1, c00, c01, c10 = _t(*_random_problem(np.random.default_rng(3), 3,
                                                7))
    e, capt, capfw = tmc.build_graph(t0, t1, c00, c01, c10)
    stats = {}
    got = tmc.solve_preflow(e, capt, capfw, 64, 16, stats=stats)
    assert torch.equal(got, tmc.solve_preflow(e, capt, capfw, 64, 16))
    assert all(stats[k].shape == (3,) for k in ("rounds", "bfs_passes",
                                                 "sweeps"))
    assert bool((stats["rounds"] >= 1).all())
    assert bool((stats["bfs_passes"] > stats["rounds"]).all())


def test_solve_graph_checks_inputs():
    e, capt, capfw = tmc.build_graph(*_t(*_random_problem(
        np.random.default_rng(4), 2, 4)))
    with pytest.raises(TypeError):
        mincut_cuda.solve_graph(e.double(), capt, capfw)
    with pytest.raises(ValueError):
        mincut_cuda.solve_graph(e, capt, capfw[:, :3])
    with pytest.raises(ValueError):
        mincut_cuda.solve_graph(e, capt, capfw.transpose(2, 3))


def test_completion_labeling_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 50, 70
    lab = np.zeros((h, w, 4), np.float32)
    lab[..., 0] = rng.normal(0, 0.05, (h, w))
    lab[..., 1] = rng.normal(0, 0.05, (h, w))
    lab[..., 2] = rng.uniform(2, 9, (h, w))
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    img[:, 20:40] = 90.0
    for block, offset in ((48, (0, 0)), (16, (5, 9)), (64, (0, 0))):
        got = tprop.completion_labeling(lab, img, block=block, offset=offset)
        want = jprop.completion_labeling(lab, img, block=block,
                                         offset=offset)
        assert got.dtype == np.float32 and got.shape == (h, w, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- solver -----

H, W, ND = 32, 48, 12
LAYERS = [2, 4, 8]
PARAMS = dict(lambda_=0.5, th_col=0.5, windR=6)


def _scene():
    r = np.random.default_rng(5)
    im = (r.random((H, W, 3)) * 255).astype(np.uint8).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    truth = np.clip(0.05 * xs - 0.04 * ys + 5.0, 1, ND - 2)
    d = np.arange(ND, dtype=np.float32)[:, None, None]
    vol = np.minimum((d - truth[None]) ** 2 * 0.2, 1.0).astype(np.float32)
    vol += (r.random(vol.shape) * 0.05).astype(np.float32)
    return im, vol


class _Recorder:
    def __init__(self, audit):
        self.audit = audit
        self.energies, self.states = [], []

    def start(self):
        pass

    def stop(self):
        pass

    def evaluate(self, solver, labeling_m, cost_m, mode, index):
        self.energies.append(float(self.audit(solver.data, solver.cfg,
                                              labeling_m, cost_m, mode)[0]))
        self.states.append((np.array(labeling_m, copy=True),
                            np.array(cost_m, copy=True)))


def _jax_solver(im, vol, seed):
    js = jeng.LocalExpansionSolver(im, im, J_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=seed)
    for i, s in enumerate(LAYERS):
        js.add_layer(s, jeng.LAYER0_PROPOSERS if i == 0
                     else jeng.COARSE_PROPOSERS)
    js.finalize()
    js.cfg = dataclasses.replace(js.cfg, gc_rounds=16, gc_sweeps=16)
    return js


@pytest.fixture(scope="module")
def solves():
    """The JAX solve of seed 1 (the external labeling), then seed 0 with
    ``fuse_with=[it]`` on both sides."""
    im, vol = _scene()
    aux = _jax_solver(im, vol, 1)
    aux.run(iterations=1, view_modes=(0,), pm_iterations=1)
    ext = np.asarray(aux._unpadded_labeling(aux._state, 0))

    js = _jax_solver(im, vol, 0)
    jrec = _Recorder(jeng.energy_audit)
    js.set_evaluator(jrec)
    js.run(iterations=1, view_modes=(0,), pm_iterations=1, fuse_with=[ext])

    ts = teng.LocalExpansionSolver(im, im, T_PARAMS.replace(**PARAMS),
                                   max_disp=float(ND - 1), vol0=vol,
                                   vol1=vol, seed=0, device="cpu")
    for i, s in enumerate(LAYERS):
        ts.add_layer(s, teng.LAYER0_PROPOSERS if i == 0
                     else teng.COARSE_PROPOSERS)
    ts.data, ts.cfg = tenergy.energy_from_numpy(js.data, js.cfg,
                                                device="cpu")
    trec = _Recorder(teng.energy_audit)
    ts.set_evaluator(trec)
    ts.run(iterations=1, pm_iterations=1, fuse_with=[ext])
    return dict(js=js, ts=ts, ext=ext, jrec=jrec, trec=trec)


def test_warm_start_unary_matches_jax(solves):
    js, ts, ext = solves["js"], solves["ts"], solves["ext"]
    jl, jc = jeng.init_from_labeling(js.data, js.cfg, ext, 0)
    tl, tc = teng.init_from_labeling(ts.data, ts.cfg, ext, 0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=2e-4)
    # Bands of image rows give the same values as one band.
    p = ts.cfg.pad
    one = tenergy.pixel_unary(ts.data, ts.cfg, 0, torch.as_tensor(ext),
                              window_budget=W * H)
    banded = tenergy.pixel_unary(ts.data, ts.cfg, 0, torch.as_tensor(ext),
                                 window_budget=3 * W)
    assert torch.equal(one, banded)
    assert torch.equal(one, tc[p:p + H, p:p + W])


@pytest.mark.parametrize("li", [0, 1])
def test_fusion_color_step_matches_jax(solves, li):
    """One fusion color step (move windows S = 6 and 12) from the JAX
    solve's post-graph-cut state against the external labeling."""
    js, ts, ext = solves["js"], solves["ts"], solves["ext"]
    lab0, cost0 = solves["jrec"].states[2]
    ext_j = jeng.init_from_labeling(js.data, js.cfg, ext, 0)
    layer = js.layers[li]
    changed = 0
    for i0, j0 in layer.colors[:4]:
        ox, oy, rmask = layer.color_regions(i0, j0)
        cox, coy = layer.canvas_origin(i0, j0)
        want = jeng.fusion_color_step(
            js.data, js.cfg, jnp.asarray(lab0), jnp.asarray(cost0), *ext_j,
            jnp.asarray(ox), jnp.asarray(oy), jnp.asarray(rmask),
            jnp.int32(cox), jnp.int32(coy), unit_size=layer.unit_size,
            nbx=layer.nbx, nby=layer.nby, mode=0)
        lab, cost = tenergy.state_from_numpy(lab0, cost0, device="cpu")
        ext_t = tenergy.state_from_numpy(*ext_j, device="cpu")
        teng.fusion_color_step(
            ts.data, ts.cfg, lab, cost, *ext_t,
            torch.as_tensor(ox, dtype=torch.int64),
            torch.as_tensor(oy, dtype=torch.int64), torch.as_tensor(rmask),
            cox, coy, unit_size=layer.unit_size, nbx=layer.nbx,
            nby=layer.nby, mode=0)
        np.testing.assert_allclose(lab.numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(cost.numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
        changed += int((lab.numpy() != lab0).any(-1).sum())
    assert changed > 0


def test_run_fuse_with_matches_jax(solves):
    je, te = solves["jrec"].energies, solves["trec"].energies
    assert len(je) == len(te) == 1 + 1 + 1 + 1
    for got, want in zip(te, je):
        assert _close(got, want), (te, je)
    assert te[3] <= te[2] + 1e-3


def test_fuse_adopts_oracle_and_is_idempotent():
    """fuse() with the state's own labeling changes nothing; with the
    planted plane it lowers or keeps the energy and adopts the plane
    somewhere (the recipe of the JAX package's fusion test)."""
    rng = np.random.default_rng(0)
    h, w, nd = 32, 48, 8
    a, b, c = 0.04, 0.02, 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = np.clip(a * xs + b * ys + c, 0, nd - 1)
    dd = np.arange(nd, dtype=np.float32)[:, None, None]
    vol = np.minimum(np.abs(dd - d_true[None]) * 0.4, 1.0).astype(np.float32)
    vol += rng.random(vol.shape, np.float32) * 0.02
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    solver = teng.LocalExpansionSolver(
        img, img, T_PARAMS.replace(windR=4, lambda_=0.5, th_col=0.5),
        max_disp=float(nd - 1), vol0=vol, vol1=vol, seed=0,
        vol_dtype="float32", device="cpu")
    solver.add_layer(3, teng.LAYER0_PROPOSERS)
    solver.run(iterations=1, pm_iterations=1)

    def energy():
        return float(teng.energy_audit(solver.data, solver.cfg,
                                       *solver._state[0], 0)[0])

    e_before = energy()
    cur = solver._unpadded_labeling().clone()
    assert torch.equal(solver.fuse(cur), cur)
    oracle = np.zeros((h, w, 4), np.float32)
    oracle[..., 0], oracle[..., 1], oracle[..., 2] = a, b, c
    fused = solver.fuse(oracle).numpy()
    assert energy() <= e_before + 1e-3
    assert bool(np.any(np.all(np.abs(fused - oracle) < 1e-6, axis=-1)))


# ---------------------------------------------------------- command line --

def test_cli_fuse_seeds_matches_jax(tmp_path):
    """-fuseSeeds 2 through both command lines on the CLI tests' scene
    (40 x 72 x 12, 1 greedy + 1 graph-cut sweep): 1 + 1 + 1 + 1 log rows
    each, energies
    within the trajectory tolerance, the fused row no higher than the last
    graph-cut row, and the same outputs."""
    _write_scene(tmp_path / "scene")
    scene = str(tmp_path / "scene")
    schedule = ["-pmIterations", "1", "-iterations", "1", "-seed", "0",
                "-fuseSeeds", "2", "-warmup", "0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng.LocalExpansionSolver, "_apply_cfg_overrides",
                   lambda self, cfg: dataclasses.replace(
                       cfg, gc_rounds=16, gc_sweeps=16))
        assert jcli.main(["-mode", "MiddV3", "-targetDir", scene,
                          "-outputDir", str(tmp_path / "jax"), "-platform",
                          "cpu", *schedule]) == 0
    assert tcli.main(["-mode", "MiddV3", "-targetDir", scene, "-outputDir",
                      str(tmp_path / "port"), "-device", "cpu",
                      *schedule]) == 0
    want, got = _log(tmp_path / "jax"), _log(tmp_path / "port")
    assert got.shape == want.shape == (4, 6)
    for g, w in zip(got[:, 1], want[:, 1]):
        assert _close(g, w), (got[:, 1], want[:, 1])
    assert got[3, 1] <= got[2, 1] + 1e-3
    for name in ("time.txt", "disp0.pfm"):
        assert (tmp_path / "port" / name).exists() == \
            (tmp_path / "jax" / name).exists()
    disp = pfm.read_pfm(str(tmp_path / "port" / "disp0.pfm"))
    assert disp.shape == (40, 72) and np.isfinite(disp).all()
