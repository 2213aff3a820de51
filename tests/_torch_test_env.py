"""Shared set-up of the port's CPU tests: every ``tests/test_torch_*.py``
imports this module before anything but the standard library.

The tier-1 command runs six pytest workers on one machine, each beside
XLA's own thread pool. Left alone, PyTorch starts one intra-op thread per
core in every worker, and again in every child Python a test starts, and
the workers crowd each other's cores. ``THREADS`` caps the worker here
(``torch.set_num_threads``) and its children through ``child_env``
(``OMP_NUM_THREADS``, ``MKL_NUM_THREADS``).

A test that waits on child processes waits through ``wait_all`` /
``run_python`` (the children it starts with ``start_python``) or
``spawned_children_limit`` (code under test that spawns its own): past the
test's limit the children are killed and the test fails with their output.
It never skips.

``tests/test_torch_imports.py::test_port_tests_cap_threads_and_bound_waits``
holds every port test file to this, by AST."""
import contextlib
import multiprocessing
import os
import pathlib
import subprocess
import sys
import threading
import time
from unittest import mock

import torch

THREADS = 2
ROOT = pathlib.Path(__file__).resolve().parent.parent
TAIL = 3000   # characters of each child's output shown on a failure

torch.set_num_threads(THREADS)


def child_env(**extra):
    """This process's environment with the thread cap, for a child Python;
    ``extra`` is set on top, and a value of None removes the name."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               MKL_NUM_THREADS=str(THREADS))
    for name, value in extra.items():
        if value is None:
            env.pop(name, None)
        else:
            env[name] = value
    return env


def _fail(message):
    import pytest
    pytest.fail(message, pytrace=False)


def start_python(args, **extra_env):
    """``python <args>`` started from the repository root with
    ``child_env(**extra_env)``, its stdout and stderr piped."""
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            env=child_env(**extra_env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def tail(done):
    """The end of a finished child's stdout and stderr, for a message."""
    return (f"--- stdout\n{done.stdout[-TAIL:]}\n"
            f"--- stderr\n{done.stderr[-TAIL:]}")


def wait_all(procs, limit_s, what):
    """A ``CompletedProcess`` for each of ``procs`` (from ``start_python``)
    once all have ended. If they are not all done ``limit_s`` seconds after
    the call, every one is killed and the test fails with what each
    printed."""
    deadline = time.monotonic() + limit_s
    try:
        outs = [p.communicate(timeout=max(0.0, deadline - time.monotonic()))
                for p in procs]
        late = False
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate(timeout=limit_s) for p in procs]
        late = True
    done = [subprocess.CompletedProcess(p.args, p.returncode, *o)
            for p, o in zip(procs, outs)]
    if late:
        _fail(f"{what}: still running after {limit_s} s, killed:\n"
              + "\n".join(tail(d) for d in done))
    return done


def run_python(args, limit_s, what, **extra_env):
    """``start_python(args, **extra_env)`` waited on for at most
    ``limit_s`` seconds (``wait_all``): its ``CompletedProcess``."""
    done, = wait_all([start_python(args, **extra_env)], limit_s, what)
    return done


@contextlib.contextmanager
def spawned_children_limit(limit_s, what):
    """For code under test that starts its own processes
    (``torch.multiprocessing.spawn``): they inherit the thread cap through
    the environment, and a watchdog kills every child process still alive
    ``limit_s`` seconds after entry; the test then fails (their output is in
    the test's captured output)."""
    fired = threading.Event()

    def kill():
        fired.set()
        for child in multiprocessing.active_children():
            child.kill()

    timer = threading.Timer(limit_s, kill)
    timer.start()
    try:
        with mock.patch.dict(os.environ, OMP_NUM_THREADS=str(THREADS),
                             MKL_NUM_THREADS=str(THREADS)):
            yield
    finally:
        timer.cancel()
        if fired.is_set():
            _fail(f"{what}: still running after {limit_s} s, killed")
