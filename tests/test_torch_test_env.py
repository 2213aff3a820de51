"""The port tests' shared set-up (``tests/_torch_test_env.py``): this worker
and every child a port test starts run with the capped thread count, and a
child still running at its test's limit is killed and fails the test with
its output instead of hanging the run or skipping. And the tier-1 timing
tool (``tests/tier1_timing.py``) on small made-up logs."""
import multiprocessing
import time

from _torch_test_env import (THREADS, run_python, spawned_children_limit,
                             start_python, wait_all)

import pytest
import torch

SLEEPER = "import time; print('started', flush=True); time.sleep(60)"


def test_worker_and_children_run_with_the_capped_thread_count():
    assert torch.get_num_threads() == THREADS
    done = run_python(["-c", "import os, torch; print(os.environ["
                       "'OMP_NUM_THREADS'], torch.get_num_threads())"],
                      60, "the thread probe")
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == [str(THREADS)] * 2


def test_a_child_past_its_limit_is_killed_and_fails_with_its_output():
    proc = start_python(["-c", SLEEPER])
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="(?s)a sleeper: still running after 3 s.*started"):
        wait_all([proc], 3, "a sleeper")
    assert proc.returncode is not None and time.monotonic() - start < 30


def test_spawned_children_past_the_limit_are_killed_and_fail():
    child = multiprocessing.get_context("spawn").Process(target=time.sleep,
                                                         args=(60,))
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="a sleeper: still running after 3 s"):
        with spawned_children_limit(3, "a sleeper"):
            child.start()
            child.join(30)
    assert child.exitcode is not None and child.exitcode < 0
    assert time.monotonic() - start < 30


def test_tier1_timing_reads_logs_and_replays_the_loadfile_queue(tmp_path,
                                                                capsys):
    """``tests/tier1_timing.py``: xdist's loadfile order (most cases first,
    ties in path order), its dispatch replayed on per-test times (a worker
    takes its next file once two or fewer of its tests are left), and the
    report of a run whose last test never finished."""
    import tier1_timing
    per_file = {"tests/a.py": [1.0] * 3, "tests/b.py": [5.0] * 10,
                "tests/c.py": [2.0] * 3}
    assert tier1_timing.queue_order({f: len(d) for f, d in per_file.items()}
                                    ) == ["tests/b.py", "tests/a.py",
                                          "tests/c.py"]
    # b fills one worker; c follows a on the other once a has two tests left
    assert tier1_timing.replay(per_file, 10.0, workers=2) == {
        "tests/a.py": (10.0, 13.0), "tests/b.py": (10.0, 60.0),
        "tests/c.py": (13.0, 19.0)}
    assert tier1_timing.replay({"tests/a.py": [1.0]}, 0.0) == {
        "tests/a.py": (0.0, 1.0)}
    # b cut into files of 2 and 8 cases: its 2-case part now queues last
    assert tier1_timing.replay(tier1_timing.split(per_file, "tests/b.py",
                                                  (2, 8)), 10.0, workers=2
                               ) == {"tests/b_1.py": (10.0, 50.0),
                                     "tests/a.py": (10.0, 13.0),
                                     "tests/c.py": (13.0, 19.0),
                                     "tests/b_0.py": (19.0, 29.0)}
    (tmp_path / "gw0.log").write_text(
        "100.0\tstart\ttests/a.py::t1\t1.5\n"
        "102.5\tfinish\ttests/a.py::t1\t2.5\n"
        "102.5\tstart\ttests/a.py::t2\t3.0\n")
    tier1_timing.report(tmp_path, t0=90.0)
    out = capsys.readouterr().out
    assert "tests/a.py::t2 (gw0, since 12.5 s)" in out
    assert "load, highest per minute: 3.0" in out
    assert tier1_timing.durations(tier1_timing.read(tmp_path)) == {
        "tests/a.py::t1": 2.5}
