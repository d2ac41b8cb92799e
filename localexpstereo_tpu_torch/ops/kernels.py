"""The port's hand-written kernels: one registry of their wrappers. Each
wrapper adds one to its ``launches`` where it launches its kernel; the
counts are read and reset here, for every kernel at once."""

from __future__ import annotations

from typing import Callable, Dict

from ..models import proposals
from . import mincut_cuda, threefry_cuda, unary_cuda


def wrappers() -> Dict[str, Callable]:
    """Each kernel's wrapper, by kernel name."""
    return {"expansion_accept": mincut_cuda.expansion_accept,
            "mincut_accept": mincut_cuda.solve_graph,
            "sample_windows": unary_cuda.sample_windows,
            "refit_sums": proposals.refit_sums,
            "threefry_uniform": threefry_cuda.uniform,
            "threefry_unit_vector": threefry_cuda.unit_vector}


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel."""
    return {k: fn.launches for k, fn in wrappers().items()}


def zero_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
