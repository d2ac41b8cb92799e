"""Loads the next pair of a multi-pair run on a thread (counterpart of
``localexpstereo_tpu.utils.prefetch``).

The reference pays the load of each MiddV3 volume up front, one pair per
process (``main.cpp:353-368``). Here a daemon thread walks the dataset
directories ahead of the consumer, the images through
:func:`.datasets.load_data` and the volumes through the threaded ``.acrt``
loader (:mod:`..native`, which releases the interpreter lock while it
reads), so the next pair's disk reads overlap the current pair's solve.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Sequence

from . import datasets


def load_v3_volumes(target_dir: str, ndisp: int, height: int, width: int,
                    announce: bool = False):
    """A MiddV3 directory's (left, right) float32 volumes with their
    out-of-view fills: ``im0.acrt``, and ``im1.acrt`` or the left one's
    L->R recovery (``main.cpp:353-368``), through the threaded loader.
    ``announce`` prints the reference's line when the right one is
    recovered."""
    from .. import native
    vol_l = native.read_acrt_fill(os.path.join(target_dir, "im0.acrt"),
                                  ndisp, height, width, fill_mode=0)
    p1 = os.path.join(target_dir, "im1.acrt")
    if os.path.exists(p1):
        return vol_l, native.read_acrt_fill(p1, ndisp, height, width,
                                            fill_mode=1)
    if announce:
        print("Cost volume file im1.acrt not found so recovered from "
              "im0.acrt.")
    return vol_l, native.convert_l2r_fill(vol_l)


class PairPrefetcher:
    """Iterates ``(dir, StereoPair, vol_l, vol_r)`` over dataset
    directories, loading up to ``depth`` items ahead of the one the
    consumer holds, on a daemon thread: with the default 1, two pairs'
    volumes are in memory at a time.

    Args:
      target_dirs: dataset directories.
      ndisp_override: forwarded to :func:`.datasets.load_data`.
      load_volumes: read the MiddV3 volumes (:func:`load_v3_volumes`);
        else the volumes are None.
      depth: items loaded ahead of the consumer (at least 1).

    A loader error is raised on the consumer's side, as a RuntimeError
    naming the directory. :attr:`load_s` holds each item's load seconds
    (by directory), :attr:`wait_s` the seconds the consumer waited for
    each item.
    """

    def __init__(self, target_dirs: Sequence[str], ndisp_override: int = 0,
                 load_volumes: bool = False, depth: int = 1):
        self.dirs = list(target_dirs)
        self.ndisp_override = ndisp_override
        self.load_volumes = load_volumes
        self.load_s: Dict[str, float] = {}
        self.wait_s: List[float] = []
        self._q: "queue.Queue" = queue.Queue()
        # One slot an item in memory: the consumer's and those ahead.
        self._slots = threading.Semaphore(max(depth, 1) + 1)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        for d in self.dirs:
            self._slots.acquire()
            t0 = time.perf_counter()
            try:
                pair = datasets.load_data(d, self.ndisp_override)
                vols: tuple = (None, None)
                if self.load_volumes:
                    h, w = pair.im0.shape[:2]
                    vols = load_v3_volumes(d, pair.ndisp, h, w)
                self.load_s[d] = time.perf_counter() - t0
                self._q.put((d, pair, *vols))
            except Exception as e:  # raised on the consumer's side
                self._q.put((d, e, None, None))
                return
        self._q.put(None)

    def __iter__(self) -> Iterator:
        first = True
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            if item is None:
                return
            self.wait_s.append(time.perf_counter() - t0)
            if not first:
                self._slots.release()       # the consumer's previous item
            first = False
            d, pair, vol_l, vol_r = item
            if isinstance(pair, Exception):
                raise RuntimeError(f"prefetch failed for {d}") from pair
            yield d, pair, vol_l, vol_r

    def volumes(self):
        """The items' (vol_l, vol_r), in order."""
        for _, _, vol_l, vol_r in self:
            yield vol_l, vol_r
