"""Energy and run configuration (copy of ``localexpstereo_tpu.config``'s
``Parameters``, presets, ``COST_FOR_INVALID`` and ``Options``; reference
``StereoEnergy.h:13-40`` and ``main.cpp:14-74``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


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


@dataclasses.dataclass
class Options:
    """Run-level options (reference ``main.cpp:14-70``; the JAX package's
    ``Options`` with ``device`` in place of its ``platform``, and without
    the settings the port does not take)."""

    mode: str = ""  # "MiddV2" or "MiddV3"
    output_dir: str = ""
    target_dir: str = ""
    iterations: int = 5
    pm_iterations: int = 2
    ndisp: int = 0
    smooth_weight: Optional[float] = None  # resolved by mode preset
    mc_threshold: float = 0.5
    filter_radius: int = 20
    seed: int = 0
    #: -doDual 1: solve both views, then the left-right post-process
    #: (consistency check, hole fill, weighted median).
    do_dual: bool = False
    #: N > 1 (-fuseSeeds): solve N - 1 more seeds before the timed solve and
    #: fuse their labelings into its result (energy-best-of-N by the fusion
    #: move); 0 or 1 solve one seed.
    fuse_seeds: int = 0
    #: V3 cost volume (-volume): "acrt" (the dataset's im0.acrt) or
    #: "mccnn" (computed from the images by the bundled MC-CNN weights).
    volume: str = "acrt"
    #: Cost-volume storage on the device: "uint8" (default; 256 levels over
    #: [0, 2*mc_threshold]), "bfloat16" or "float32" (-volPrecision).
    vol_precision: str = "uint8"
    #: Unary route of the sweeps (-unaryBackend): "auto" (the fused
    #: sampling + filter kernel on the card where it has a launch plan,
    #: else the plain sampler + guided filter) or "dma" (the kernel
    #: always; its plain version on the CPU).
    unary_backend: str = "auto"
    #: 1 runs a throwaway solve (at most one sweep of each kind) before the
    #: evaluator's timer starts: it builds the kernel libraries and pays the
    #: device's first-use costs, so time.txt measures the solve alone
    #: (TimeStamper semantics).
    warmup: int = 1
    #: "cuda" (the default) or "cpu": where the energy and the state live.
    #: "cuda" without a card raises.
    device: str = "cuda"
    #: Live progress display (-show): live_D.png / live_E.png overwritten
    #: under outputDir/debug at every evaluation (Evaluator.h:145-160).
    show: bool = False

    def resolve_smooth_weight(self) -> float:
        """Mode presets (``main.cpp:37-40``): MiddV2 -> 1.0, MiddV3 -> 0.5,
        unless overridden on the command line."""
        if self.smooth_weight is not None:
            return self.smooth_weight
        if self.mode == "MiddV3":
            return 0.5
        return 1.0
