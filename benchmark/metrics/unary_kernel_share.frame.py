"""Share, in %, of the program's ``unary`` spans inside the ``sweep`` spans
of the cold frames completed in the window whose ``route`` attribute is
"kernel": the color steps whose unary ran the fused sampling + guided-filter
kernel (``csrc/sample_windows.cu``) rather than the plain sampler and
filter. None where the spans carry no ``route`` (a checkout that does not
record it), or where there is nothing to read."""

import numpy as np

from benchmark import readers, spans, trace


def read(run):
    frames = readers.frames_of(run, "cold")
    sp = spans.recorded()
    if run.device is None or not frames or sp is None:
        return None
    from localexpstereo_tpu_torch.utils import profiling
    records = profiling.records()
    hit = (trace.in_intervals(sp.start,
                              [(f["start"], f["end"]) for f in frames])
           & sp.within(("sweep",)) & (sp.name == "unary"))
    routes = [getattr(records[i], "attrs", {}).get("route")
              for i in np.flatnonzero(hit)]
    if not routes or None in routes:
        return None
    return 100.0 * routes.count("kernel") / len(routes)
