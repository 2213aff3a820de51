"""The four examples of the JAX package's ``examples/``, on the port.

Each module is the twin of the file of the same name there: the same
problem (robot, costs, constraints, horizon, options), iteration counts and
printed lines, run with ``python -m idocp_tpu_torch.examples.<name>
[--device cpu]``. Each ``main`` takes the device, the dtype (f32 by default,
as the twins run JAX without x64) and the problem's sizes, and returns the
numbers it prints.
"""
import argparse

import torch


def synchronize(device):
    """Wait for the card before reading the host clock."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(description, policy=False):
    """The examples' command line: ``--device`` (cuda) and, for the trot,
    ``--policy``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda")
    if policy:
        parser.add_argument("--policy", action="store_true",
                            help="compare the zero-order hold against the "
                                 "LQR policy between updates")
    return parser.parse_args()
