"""A pytest plugin: JAX's XLA backend-compile seconds and compile counts per
test file.

JAX reports each compile's phases through ``jax.monitoring``; the plugin
sums ``/jax/core/compile/backend_compile_duration`` (XLA's compile of a
lowered program) per test file, counts those events (one per distinct
program compiled), and also sums the tracing and lowering before it. A
compile during a module fixture's setup or teardown counts for the file of
the test that triggered it; one during collection counts as
``<collection>``. At the end it prints one line per file, most compile
seconds first. Run it from the repository root on one file:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sweep.py -q \\
        -p tools.jax_compile_seconds

or over several files (each file's numbers are its own only when a
process runs one file, since JAX's in-memory cache serves a program that
an earlier file compiled):

    for f in tests/test_torch_*.py; do JAX_PLATFORMS=cpu python -m pytest "$f" -q \\
        -p tools.jax_compile_seconds --jax-compile-json /tmp/compiles; done
    python tools/jax_compile_seconds.py /tmp/compiles   # the table of all files

``--jax-compile-top N`` also prints the N slowest compiles, each with the
test that ran it and the name of the program. ``--jax-compile-json DIR``
also writes the counts of each process as JSON
into DIR (one file per process, so it works under xdist as well), and
running the module as a script sums such a directory into one table.
"""

from __future__ import annotations

import collections
import json
import os
import sys

BACKEND = "/jax/core/compile/backend_compile_duration"
TRACE = "/jax/core/compile/jaxpr_trace_duration"
LOWER = "/jax/core/compile/jaxpr_to_mlir_module_duration"

_current = ["<collection>", "<collection>"]  # the file and the test running
_programs: list = []  # (seconds, test, program name) of each backend compile
_totals: "collections.defaultdict[str, dict]" = collections.defaultdict(
    lambda: {"backend_s": 0.0, "compiles": 0, "trace_s": 0.0, "lower_s": 0.0, "tests": 0})


def _listener(event: str, duration: float, fun_name: str = "?", **_) -> None:
    row = _totals[_current[0]]
    if event == BACKEND:
        row["backend_s"] += duration
        row["compiles"] += 1
        _programs.append((duration, _current[1], fun_name))
    elif event == TRACE:
        row["trace_s"] += duration
    elif event == LOWER:
        row["lower_s"] += duration


def pytest_addoption(parser) -> None:
    parser.addoption("--jax-compile-json", default=None,
                     help="directory to write this process's per-file compile counts to")
    parser.addoption("--jax-compile-top", type=int, default=0,
                     help="also print the N slowest compiles, each with its test and program")


def pytest_configure(config) -> None:
    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(_listener)


def pytest_runtest_logstart(nodeid, location) -> None:
    _current[:] = [nodeid.split("::")[0], nodeid]
    _totals[_current[0]]["tests"] += 1


def table(totals) -> str:
    lines = [f"{'backend s':>10} {'compiles':>8} {'trace s':>8} {'lower s':>8} {'tests':>5}  file"]
    for f, r in sorted(totals.items(), key=lambda kv: -kv[1]["backend_s"]):
        lines.append(f"{r['backend_s']:10.2f} {r['compiles']:8d} {r['trace_s']:8.2f} "
                     f"{r['lower_s']:8.2f} {r['tests']:5d}  {f}")
    s = sum(r["backend_s"] for r in totals.values())
    n = sum(r["compiles"] for r in totals.values())
    lines.append(f"{s:10.2f} {n:8d} {'':8} {'':8} {'':5}  all files")
    return "\n".join(lines)


def pytest_sessionfinish(session) -> None:
    out = session.config.getoption("--jax-compile-json")
    if out:
        os.makedirs(out, exist_ok=True)
        name = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(os.path.join(out, f"{name}-{os.getpid()}.json"), "w") as f:
            json.dump(dict(_totals), f)


def pytest_terminal_summary(terminalreporter, config) -> None:
    if not hasattr(config, "workerinput"):  # under xdist the workers' rows are in the JSON
        terminalreporter.write_sep("-", "JAX backend compiles per test file")
        terminalreporter.write_line(table(_totals))
        for secs, test, name in sorted(_programs, reverse=True)[:config.getoption(
                "--jax-compile-top")]:
            terminalreporter.write_line(f"{secs:8.2f} s  {name}  {test}")


def main(argv=None) -> None:
    """Sum a ``--jax-compile-json`` directory into one table."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python tools/jax_compile_seconds.py DIR")
    totals: dict = {}
    for name in sorted(os.listdir(argv[0])):
        with open(os.path.join(argv[0], name)) as f:
            for file, row in json.load(f).items():
                acc = totals.setdefault(file, dict.fromkeys(row, 0))
                for k, v in row.items():
                    acc[k] += v
    print(table(totals))


if __name__ == "__main__":
    main()
