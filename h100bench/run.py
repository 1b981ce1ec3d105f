"""Run one cell of the port's benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``biscuit_torch``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and ``breakdown``; ``checks`` last: each compared number beside
its limit, also the last lines of standard error, after the window's
kernel launches, every number read and the parts of set-up). A run needs a CUDA
card: without one, or with fewer than the cell asks for, it exits with
code 2 and prints no result. It also prints none, and exits with code 3,
if the process has loaded JAX, a JAX library or the JAX package."""

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the ``time.time`` clock (from /proc; the
    module's load where /proc is not there)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROC = _process_start()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The configuration names the program's path; switches of the
    # program's environment would change it under the cell.
    for key in [k for k in os.environ if k.startswith("BISCUIT_")]:
        del os.environ[key]
    sys.path.insert(0, str(ROOT))

    import torch

    from h100bench.harness import drive, guard, spec

    cell = spec.load_cell(args.workload)
    chips = cell.workload.get("chips", 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{cards}", file=sys.stderr)
        return 2
    breaches = guard.reference_breaches()
    if breaches:
        print(f"the reference imports {breaches}", file=sys.stderr)
        return 3
    # wall clock of the process start -> the perf_counter clock
    t_proc = time.perf_counter() - (time.time() - T_PROC)
    line, record = drive.execute(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 t_proc)
    found = guard.loaded_forbidden()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    for key, value in record.items():
        print(f"{key}: {json.dumps(value)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
