"""Device ms per update of the parallel-in-time recursion's switching
correction (the slots, the two affine scans of the unit injections, G, the
multipliers' dense system and its LU, the corrected direction): the
program's span ``idocp.riccati.switching``
(``idocp_tpu_torch/riccati/parallel.py::parallel_constrained``), timed on
the device from the event a replayed update records where it opens to the
one where it closes (``benchmark/timed_spans.py``: the kernels and the
stream's gaps between the span's graph launches), over the traced steps'
updates.
Nothing to read without switching rows, on the serial sweep, in an eager
update or in a program without the span."""
from benchmark import timed_spans

SPANS = ("idocp.riccati.switching",)


def read(ctx):
    return timed_spans.ms_per_update(ctx, SPANS)
