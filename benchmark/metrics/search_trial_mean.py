"""Trials the filter line search needed, on average: the mean of
``ls_trial + 1`` over the scenario-updates of the traced steps whose search
accepted a trial, from the counters the program keeps while the profiler
records (``idocp_tpu_torch.utils.tracing.counters()``:
``idocp.update.ls_trial`` and ``idocp.update.ls_accepted``). Each update
evaluates the whole grid of trials; this says how many were needed."""
import importlib


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        tracing = importlib.import_module("idocp_tpu_torch.utils.tracing")
    except ImportError:
        return None
    kept = tracing.counters()
    trial = kept.get("idocp.update.ls_trial")
    accepted = kept.get("idocp.update.ls_accepted")
    if trial is None or accepted is None or trial.shape != accepted.shape:
        return None
    accepted = accepted.bool()
    if not bool(accepted.any()):
        return None
    return float((trial[accepted] + 1).double().mean())
