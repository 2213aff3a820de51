"""The share, in %, of the parallel recursion's switching slots that the
schedules fill: the stages with switching rows per scenario-window
(counter ``idocp.schedule.sw_stages``, kept from the schedule's host masks)
over the slots the switching correction holds per scenario-window
(``idocp.riccati.sw_slots``, the solver's ``max_impulse_stages``, kept
per update), as means over the traced steps
(``idocp_tpu_torch.utils.tracing.counters()``). What is left of 100 % is
padding of the correction's (k ns)^2 system. A program without the
counters, or on the serial sweep, gives nothing to read."""
import importlib


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        tracing = importlib.import_module("idocp_tpu_torch.utils.tracing")
    except ImportError:
        return None
    kept = tracing.counters()
    stages = kept.get("idocp.schedule.sw_stages")
    slots = kept.get("idocp.riccati.sw_slots")
    if stages is None or slots is None or not stages.numel() or not slots.numel():
        return None
    held = float(slots.double().mean())
    return 100.0 * float(stages.double().mean()) / held if held > 0 else None
