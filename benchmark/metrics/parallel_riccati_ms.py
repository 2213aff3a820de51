"""Device ms per update of the parallel-in-time Riccati recursion's
backward pass (the elements, the suffix scan, the gains) and rollout: the
program's spans ``idocp.riccati.backward`` and ``idocp.riccati.rollout``
(``idocp_tpu_torch/riccati/parallel.py``), timed on the device from the
event a replayed update records where each opens to the one where it closes
(``benchmark/timed_spans.py``: the kernels and the stream's gaps between
the span's graph launches), over the traced steps' updates. Nothing to
read on the serial sweep, in an eager update or in a program without the
spans."""
from benchmark import timed_spans

SPANS = ("idocp.riccati.backward", "idocp.riccati.rollout")


def read(ctx):
    return timed_spans.ms_per_update(ctx, SPANS)
