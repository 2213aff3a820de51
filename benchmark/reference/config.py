"""The reference's reading of a configuration file."""
from __future__ import annotations

import pathlib

import torch

from . import ocp, rigid

ROOT = pathlib.Path(__file__).resolve().parents[2]


def model(cfg, device="cpu", root=ROOT):
    rob = cfg["robot"]
    return rigid.Model(pathlib.Path(root) / rob["reference_urdf"],
                       rob["floating_base"],
                       dtype=torch.float64, device=device)


def spec(cfg, m, q_ref):
    """The problem the configuration states, for ``ocp.Reference``; q_ref
    (nq,) where the configuration takes it from the nominal pose."""
    kw = m.kw
    c, o = cfg["cost"], cfg["solver"]["options"]
    t = lambda x: torch.as_tensor(x, **kw)
    return ocp.Spec(
        model=m, T=float(cfg["horizon"]["T"]), N=int(cfg["horizon"]["N"]),
        weights={k: t(c[k + "_weight"]) for k in ("q", "v", "a", "u", "qf", "vf")},
        q_ref=t(q_ref if c["q_ref"] == "nominal" else c["q_ref"]),
        constraints=tuple(cfg["constraints"]),
        feet=tuple(cfg["robot"]["contact_frames"]),
        kp=float(cfg["robot"]["baumgarte_kp"]),
        kd=float(cfg["robot"]["baumgarte_kd"]),
        mu_friction=float(cfg["friction_mu"]),
        barrier=float(o["barrier"]), tau=float(o["fraction_to_boundary"]),
        min_slack=float(o["min_slack"]), max_step=float(o["max_step_norm"]),
        line_search=bool(o["use_line_search"]),
        trials=int(o["line_search_alphas"]),
        filter_size=int(o["line_search_filter_size"]),
        margin=float(o["line_search_margin"]))


def check_stated(cfg):
    """The reference states no Riccati regularization; refuse a
    configuration that asks for one."""
    if float(cfg["solver"]["options"]["riccati_regularization"]) != 0.0:
        raise ValueError("the reference solves the unregularized Newton step")
