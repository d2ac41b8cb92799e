"""Energy configuration (copy of ``localexpstereo_tpu.config``'s
``Parameters``, presets and ``COST_FOR_INVALID``; reference
``StereoEnergy.h:13-40`` and ``main.cpp:72-74``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Energy hyper-parameters (reference ``StereoEnergy.h:13-40``).

    Attributes:
      alpha: color/gradient blend of the V2 data term.
      omega: bandwidth of the pairwise color weights, on 0..255 intensities.
      th_grad / th_col: truncation of the V2 gradient / color terms. For the
        cost-volume (V3) energy, ``th_col`` is reused as tau_CNN.
      lambda_: smoothness weight.
      th_smooth: truncation of the pairwise curvature term.
      epsilon: lower bound of the pairwise weight.
      filter_param1: guided-filter eps.
      windR: window radius; the guided filter uses radius ``windR // 2``.
      neighbor_num: 4 or 8 neighborhood.
      filter_name: "GF", "GFfloat", "BF" or "" (no filtering).
    """

    alpha: float = 0.9
    omega: float = 10.0
    th_grad: float = 2.0
    th_col: float = 10.0
    lambda_: float = 1.0
    th_smooth: float = 1.0
    epsilon: float = 0.01
    filter_param1: float = 1e-4
    windR: int = 20
    neighbor_num: int = 8
    filter_name: str = "GF"

    @property
    def guided_radius(self) -> int:
        return self.windR // 2

    def replace(self, **kw) -> "Parameters":
        return dataclasses.replace(self, **kw)


#: Presets from ``main.cpp:72-74``.
PARAMS_GF = Parameters(lambda_=1.0, windR=20, filter_name="GF",
                       filter_param1=1e-4)
PARAMS_GF_FLOAT = PARAMS_GF.replace(filter_name="GFfloat")
PARAMS_BF = Parameters(lambda_=20.0, windR=20, filter_name="BF",
                       filter_param1=10.0)

#: Unary cost assigned to invalid labels (``StereoEnergy.h:45``).
COST_FOR_INVALID = 1e6
