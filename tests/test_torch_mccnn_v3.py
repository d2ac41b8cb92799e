"""The port's MC-CNN accuracy check at V3 geometry
(``tools/mccnn_v3_eval.py`` of the port) against the JAX package's tool, on
the CPU at scale 0.125 (124 x 179, 18 disparities).

Tolerances: the pair bitwise equal (the same numpy draws); the WTA bad
rates within 0.1 point of the JAX network's (the two volumes agree to
about 1e-6, ``tests/test_torch_mccnn.py``, so only near-tied minima can
differ).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localexpstereo_tpu.models import mccnn as jmccnn
from localexpstereo_tpu_torch.models import mccnn
from localexpstereo_tpu_torch.tools import mccnn_v3_eval as tool

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import mccnn_v3_eval as jtool  # noqa: E402

torch.set_num_threads(1)

SCALE = 0.125


def test_geometry_is_the_jax_tools():
    assert tool.geometry(SCALE) == (124, 179, 18)
    assert tool.geometry(1.0) == (992, 1436, 145)


def test_build_pair_matches_jax_tool():
    h, w, nd = tool.geometry(SCALE)
    got = tool.build_pair(h, w, nd)
    want = jtool.build_pair(h, w, nd)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g, x)
    assert got[3].mean() > 0.5                  # mostly in view


def test_wta_bad_rates_match_jax():
    h, w, nd = tool.geometry(SCALE)
    im_l, im_r, truth, valid = tool.build_pair(h, w, nd)
    params = mccnn.load_default_params()
    vol, _, _ = tool.volume(mccnn.params_from_jax(params), im_l, im_r, nd)
    got = tool.bad_rates(tool.wta(vol), truth, valid)
    jvol = jmccnn.cost_volume({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(im_l), jnp.asarray(im_r), ndisp=nd)
    jwta = np.asarray(jnp.argmin(jvol, axis=0).astype(jnp.float32))
    want = tool.bad_rates(jwta, truth, valid)
    assert got == pytest.approx(want, abs=0.1)
    assert 0.0 < got[1] <= got[0] < 100.0

