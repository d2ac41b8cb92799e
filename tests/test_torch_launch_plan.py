"""The graph-cut kernels' launch plan (``mincut_cuda.launch_plan``), on the
CPU: Hopper's limits, the row bands, and the plans of the main path's
window sizes. The kernels under these plans run in test_torch_cuda.py."""
import pytest

from localexpstereo_tpu_torch.ops import mincut_cuda as mc

#: The main path's (S, N) and the plan each gets: (K, threads, dynamic
#: shared-memory bytes, state, band rows).
MAIN_PATH = {
    (42, 468): (1, 512, 95_256, "shared", 42),
    (129, 54): (2, 1024, 184_470, "banded", 65),
    (387, 6): (16, 1024, 212_850, "banded", 25),
}


@pytest.mark.parametrize("n", [1, 6, 54, 468])
@pytest.mark.parametrize("s", [1, 9, 42, 129, 260, 387, 400])
def test_plan_within_hopper_limits(s, n):
    plan = mc.launch_plan(s, n)
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes + mc.SMEM_STATIC <= 232_448
    # K = 1 exactly while the whole solve state fits one block.
    fits = s * s * mc.SHARED_PX_BYTES + mc.SMEM_STATIC <= 232_448
    assert (plan.cluster == 1) == fits == (plan.state == "shared")
    px = {"shared": s * s, "banded": plan.band_rows * s, "global": 0}
    per_px = (mc.SHARED_PX_BYTES if plan.state == "shared"
              else mc.BANDED_PX_BYTES)
    assert plan.smem_bytes == px[plan.state] * per_px
    # The bands cover rows 0..S-1 exactly once, in rank order.
    rows = [y for lo, hi in plan.bands(s) for y in range(lo, hi)]
    assert rows == list(range(s))
    assert len(plan.bands(s)) == plan.cluster


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
def test_main_path_plans(shape):
    plan = mc.launch_plan(*shape)
    assert (plan.cluster, plan.threads, plan.smem_bytes, plan.state,
            plan.band_rows) == MAIN_PATH[shape]
    assert plan.work_slots(mc.TABLE_PLANES) == (
        mc.TABLE_PLANES + mc.STATE_SLOTS[plan.state])


def test_plan_takes_the_largest_cluster_that_fits_one_wave():
    """K follows the card's count of clusters that fit at once: 16 while
    N clusters of 16 fit, else the next size down; 2 if none fits."""
    def card(fit16):
        return lambda plan: fit16 * 16 // plan.cluster
    assert mc.launch_plan(387, 6, card(6)).cluster == 16
    assert mc.launch_plan(387, 6, card(5)).cluster == 8
    assert mc.launch_plan(387, 6, card(5)).state == "global"
    assert mc.launch_plan(129, 54, card(7)).cluster == 2
    assert mc.launch_plan(129, 200, card(7)).cluster == 2


@pytest.mark.parametrize("s,k", [(9, 16), (40, 16), (130, 16), (387, 8),
                                 (1000, 16)])
def test_cluster_plan_bands(s, k):
    """Short and empty last bands (S < K, S not a multiple of K), and bands
    too large for shared memory, which fall back to the global state."""
    plan = mc.cluster_plan(s, k)
    bands = plan.bands(s)
    assert bands[0][0] == 0 and bands[-1][1] == s
    assert all(hi - lo <= plan.band_rows for lo, hi in bands)
    assert sum(hi - lo for lo, hi in bands) == s
    if s < k:
        assert bands[-1] == (s, s)
    big = plan.band_rows * s * mc.BANDED_PX_BYTES > 232_448 - mc.SMEM_STATIC
    assert plan.state == ("global" if big else "banded")
    assert mc.cluster_plan(s, k, "global").smem_bytes == 0


@pytest.mark.parametrize("s", [0, mc.MAX_S])
def test_plan_refuses_windows_the_kernels_cannot_index(s):
    with pytest.raises(ValueError):
        mc.launch_plan(s, 1)
