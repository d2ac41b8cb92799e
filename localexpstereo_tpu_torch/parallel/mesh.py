"""The device list of the port's data parallelism (counterpart of
``localexpstereo_tpu.parallel.mesh``): where the JAX package builds a
``Mesh`` over its chips, the port's :class:`.replica.ReplicaSolver` takes
a plain list of torch devices, one pair at a time on each.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def make_devices(n: Optional[int] = None, kind: str = "cuda"
                 ) -> List[torch.device]:
    """The first ``n`` (default: every) visible CUDA device; raises
    without one. ``kind`` "cpu" gives ``n`` (default 1) CPU entries, one
    worker each, for running the process path on a host without a card."""
    if kind == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if kind != "cuda":
        raise ValueError(f"kind {kind!r}: 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available (pass kind='cpu' "
                           "to run on the CPU)")
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError(f"n {n}: {count} CUDA device(s) are visible")
    return [torch.device(f"cuda:{i}") for i in range(n)]
