"""Per-file timing of the tier-1 pytest run (the command in ROADMAP.md), the
source of the test-time tables in PERF.md.

As a pytest plugin: ``-p tier1_timing`` with ``tests`` on ``PYTHONPATH`` and
``TIER1_TIMING_DIR`` set. Every process (each xdist worker, and the
controller as ``main``) appends a line per test start and finish to
``<dir>/<worker>.log``: the wall clock, the event, the test id and the
machine's one-minute load average.

As a script: ``python tests/tier1_timing.py <dir> [--t0 SECONDS]
[--collected FILE] [--split FILE=N,N,...]`` reads those logs and prints, per
file, its worker, its start and end in seconds after t0 (default: the first
event), its wall time and the cases it started; the order in which
``--dist loadfile`` hands files out (most cases first, ties in collection
order; the counts of FILE, the output of ``pytest --collect-only -q``, where
a cut run did not start every case), and that order replayed on the logged
per-test times (six workers; a worker takes its next file once two or fewer
of its tests are left), each ``--split`` cutting a file's tests, in the order
they ran, into files of those sizes before the replay; the tests still
running when the logs end (a run cut by its time limit); and the highest
load average of each minute."""
import argparse
import collections
import os
import pathlib
import time

_DIR = os.environ.get("TIER1_TIMING_DIR")


def _log(kind, nodeid):
    if not _DIR:
        return
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(os.path.join(_DIR, f"{worker}.log"), "a") as f:
        f.write(f"{time.time():.3f}\t{kind}\t{nodeid}\t"
                f"{os.getloadavg()[0]:.2f}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("finish", nodeid)


def read(log_dir):
    """{worker: [(time, kind, test id, load or None)]} from the workers'
    logs, or from ``main.log`` of a run without workers (``-n 0``)."""
    out = {}
    paths = sorted(pathlib.Path(log_dir).glob("gw*.log"))
    for path in paths or [pathlib.Path(log_dir) / "main.log"]:
        rows = []
        for line in path.read_text().splitlines():
            t, kind, nodeid, *load = line.split("\t")
            rows.append((float(t), kind, nodeid,
                         float(load[0]) if load else None))
        out[path.stem] = rows
    return out


def durations(logs):
    """Test id -> seconds from start to finish, in each worker's order."""
    out = {}
    for rows in logs.values():
        started = {}
        for t, kind, nodeid, _ in rows:
            if kind == "start":
                started[nodeid] = t
            else:
                out[nodeid] = t - started.pop(nodeid)
    return out


def queue_order(cases):
    """xdist's order for ``--dist loadfile``: files by case count, most
    first, ties in collection (path) order."""
    return sorted(sorted(cases), key=lambda f: -cases[f])


def replay(per_file, start_s, workers=6):
    """The dispatch of ``queue_order`` replayed on per-test seconds
    (``per_file``: file -> list of seconds): file -> (start, end)."""
    queue = collections.deque(queue_order(
        {f: len(d) for f, d in per_file.items()}))
    pending = [collections.deque() for _ in range(workers)]
    clock = [start_s] * workers
    span = {}

    def give(w):
        name = queue.popleft()
        pending[w].extend((name, d) for d in per_file[name])

    for w in range(workers):
        if queue:
            give(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            give(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]),
                key=lambda w: clock[w] + pending[w][0][1])
        name, d = pending[w].popleft()
        first, _ = span.get(name, (clock[w], None))
        clock[w] += d
        span[name] = (first, clock[w])
        if queue and len(pending[w]) <= 2:
            give(w)
    return span


def collected(listing):
    """File -> cases, from the output of ``pytest --collect-only -q``."""
    return collections.Counter(line.split("::")[0]
                               for line in listing.splitlines()
                               if "::" in line)


def split(per_file, name, sizes):
    """``per_file`` with file ``name``'s tests cut, in order, into files
    ``name[:-3]_<k>.py`` of the given sizes."""
    out = {f: d for f, d in per_file.items() if f != name}
    tests = per_file[name]
    if sum(sizes) != len(tests):
        raise ValueError(f"{name} has {len(tests)} tests, not {sum(sizes)}")
    for k, size in enumerate(sizes):
        out[f"{name[:-3]}_{k}.py"], tests = tests[:size], tests[size:]
    return out


def report(log_dir, t0=None, counts=None, splits=()):
    logs = read(log_dir)
    events = [r for rows in logs.values() for r in rows]
    t0 = min(r[0] for r in events) if t0 is None else t0
    files, cases = {}, collections.Counter()
    for worker, rows in logs.items():
        for t, kind, nodeid, _ in rows:
            name = nodeid.split("::")[0]
            start, end, _ = files.get(name, (t - t0, None, worker))
            files[name] = (start, t - t0 if kind == "finish" else end,
                           worker)
            cases[name] += kind == "start"
    print(f"{'file':42s} {'worker':6s} {'start':>8s} {'end':>8s} "
          f"{'wall':>8s} {'cases':>5s}")
    for name, (start, end, worker) in sorted(files.items(),
                                             key=lambda kv: kv[1][0]):
        wall = "cut" if end is None else f"{end - start:8.1f}"
        end = "cut" if end is None else f"{end:8.1f}"
        print(f"{name:42s} {worker:6s} {start:8.1f} {end:>8s} {wall:>8s} "
              f"{cases[name]:5d}")
    counts = counts or cases
    print("queue:", " ".join(f"{pathlib.Path(f).stem}:{counts[f]}"
                             for f in queue_order(counts)))
    per_file = collections.defaultdict(list)
    for nodeid, d in durations(logs).items():
        per_file[nodeid.split("::")[0]].append(d)
    if sum(map(len, per_file.values())) == sum(cases.values()):
        for name, sizes in splits:
            per_file = split(per_file, name, sizes)
        span = replay(per_file, min(s for s, _, _ in files.values()))
        print("replayed (start, end):", {
            pathlib.Path(f).stem: (round(s, 1), round(e, 1))
            for f, (s, e) in span.items() if e > 0.75 * max(
                e for _, e in span.values())})
    for worker, rows in logs.items():
        t, kind, nodeid, _ = rows[-1]
        if kind == "start":
            print(f"running at the end: {nodeid} ({worker}, since "
                  f"{t - t0:.1f} s)")
    load = collections.defaultdict(float)
    for t, _, _, value in events:
        if value is not None:
            minute = int((t - t0) // 60)
            load[minute] = max(load[minute], value)
    if load:
        print("load, highest per minute:", " ".join(
            f"{v:.1f}" for _, v in sorted(load.items())))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("log_dir")
    parser.add_argument("--t0", type=float, default=None,
                        help="the run's start (epoch seconds)")
    parser.add_argument("--collected", default=None,
                        help="the output of pytest --collect-only -q")
    parser.add_argument("--split", action="append", default=[],
                        help="FILE=N,N,...: replay FILE cut into files of "
                             "these sizes")
    args = parser.parse_args()
    report(args.log_dir, args.t0, args.collected and collected(
        pathlib.Path(args.collected).read_text()),
        [(f, [int(n) for n in sizes.split(",")])
         for f, sizes in (s.split("=") for s in args.split)])
