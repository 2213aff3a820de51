"""Device ms per update of the hand kernel of the inverse-dynamics
derivatives (``idocp_tpu_torch/ops/csrc/id_derivatives.cu``, entry function
``id_derivatives_kernel``), launched once inside each of the program's
``idocp.update.linearize.id_derivatives`` spans, over the traced steps'
updates. The kernel's device time is read only where its launches and the
spans are as many; a program without the span or the kernel gives nothing
to read."""
from benchmark import spans

SPAN = "idocp.update.linearize.id_derivatives"
ENTRY = "id_derivatives_kernel"


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    _, found = spans.launches_in(tr, SPAN)
    us, count = tr.device_us_of((ENTRY,))
    updates = len(spans.of(tr, "idocp.update"))
    if not found or count != found or not updates:
        return None
    return 1e-3 * us / updates
