#!/usr/bin/env python3
"""How pytest-xdist's ``--dist loadfile`` packs the tier-1 tests, from the
junit report of a run. Run from the repository root:

    python3 tools/tier1_schedule.py /tmp/_t1.xml [--workers 6] [--top 20]

or, before any run, the queue's head from the collected test ids:

    python -m pytest tests/ --collect-only -q -m 'not slow' -p no:cacheprovider \
        > /tmp/collect.txt
    python3 tools/tier1_schedule.py --collect /tmp/collect.txt

``--collect`` prints the first ``--workers`` files of the queue, which
start at once, with their test counts, and exits 1 unless JAX's
``tests/test_hyperbolic_model.py``, the longest file, is among them: a
file queued after them starts only when a worker frees up.

``loadfile`` sends each test file whole to one worker. It queues the files
by their number of tests, largest first (ties in collection order), gives
each worker one file, and gives a worker its next file as soon as two of
its assigned tests are left. So a file still queued when the longest file
(JAX's ``tests/test_hyperbolic_model.py``) is down to its last two tests
runs after it on the same worker, and files with few but long tests start
late. The script replays that queue with each test's junit time and
prints, per worker, the files in the order it took them (with the time it
took each) and when it ends; then the replayed wall, the junit's total
test-seconds and the port's (``tests/test_torch_*.py``), and the ``--top``
files by test-seconds. The replay holds each test's time fixed, so it
shows the packing, not how the load of one file slows another.
"""

from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path: str) -> "collections.OrderedDict[str, list]":
    """file (the junit classname) -> [seconds of each test], in run order."""
    files: "collections.OrderedDict[str, list]" = collections.OrderedDict()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname")
        if name:
            files.setdefault(name, []).append(float(case.get("time", 0.0)))
    return files


def replay(files, workers: int):
    """(the wall, per worker its end and [(file, time taken)])."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    pending = [[] for _ in range(workers)]
    clock = [0.0] * workers
    taken = [[] for _ in range(workers)]

    def assign(w):
        if queue:
            f = queue.pop(0)
            pending[w].extend(files[f])
            taken[w].append((f, clock[w]))

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w])
        clock[w] += pending[w].pop(0)
        if len(pending[w]) <= 2:
            assign(w)
    return max(clock), list(zip(clock, taken))


FLOOR_FILE = "tests/test_hyperbolic_model.py"


def collected(path: str) -> "collections.OrderedDict[str, int]":
    """file -> its number of tests, in collection order, from the output of
    ``pytest --collect-only -q``."""
    counts: "collections.OrderedDict[str, int]" = collections.OrderedDict()
    with open(path) as f:
        for line in f:
            if "::" in line:
                name = line.split("::")[0].strip()
                counts[name] = counts.get(name, 0) + 1
    return counts


def queue_head(counts, workers: int) -> list:
    """The first ``workers`` files of loadfile's queue: most tests first,
    ties in collection order."""
    return sorted(counts, key=lambda f: -counts[f])[:workers]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit", nargs="?")
    ap.add_argument("--collect", metavar="OUTPUT",
                    help="the output of pytest --collect-only -q instead of a junit report")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if args.collect:
        counts = collected(args.collect)
        head = queue_head(counts, args.workers)
        for f in head:
            print(f"{counts[f]:4d} tests  {f}")
        if FLOOR_FILE not in head:
            raise SystemExit(f"{FLOOR_FILE} ({counts.get(FLOOR_FILE, 0)} tests) is not among "
                             f"the first {args.workers} files of the queue")
        print(f"{FLOOR_FILE} starts at once ({head.index(FLOOR_FILE) + 1} of {args.workers})")
        return
    if not args.junit:
        ap.error("a junit report or --collect is needed")
    files = load(args.junit)
    wall, per_worker = replay(files, args.workers)
    for w, (end, taken) in enumerate(per_worker):
        print(f"worker {w} ends {end:.0f} s: "
              + ", ".join(f"{f.split('.')[-1]} @{t:.0f}" for f, t in taken))
    total = {f: sum(v) for f, v in files.items()}
    port = sum(v for f, v in total.items() if f.split(".")[-1].startswith("test_torch_"))
    print(f"replayed wall {wall:.1f} s; test-seconds {sum(total.values()):.1f}, "
          f"the port's {port:.1f}")
    for f, v in sorted(total.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"{v:8.1f} s {len(files[f]):4d} tests  {f.split('.')[-1]}")


if __name__ == "__main__":
    main()
