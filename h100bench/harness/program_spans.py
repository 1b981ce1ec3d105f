"""The port's own spans (``biscuit.*``, ``biscuit_torch/tracing.py``) in a
traced run, and the per-layer numbers they give. Nothing in the harness
calls this module yet: ``attribute`` reads the same profiler events as
``trace.summarize``, so that it can become a part of the summary as it
stands.

    python3 -m h100bench.harness.program_spans <cell> <seed> <seconds>

runs the cell once as ``run.py --trace 1`` does, from the root of a
checkout on a CUDA card, and prints the result line, then one line
``program_spans {...}``: each span's occurrences and host and device
seconds, ``numbers`` (a value for each name of ``NUMBERS`` whose span
the cell passes through), ``coverage`` and the device operations that no
stage holds.

Attribution is by launch time. A kernel, memcpy or memset of the window
belongs to a span of the window's thread when the host call that
launched it (or, with no such call, the op it is linked to) starts
inside one of the span's occurrences, whatever thread made the call:
autograd launches the backward from its own thread while the main
thread sits in ``train.backward``. It is inclusive: ``serve.trunk``
holds the operations of ``trunk.entry`` too. Times are cut to the
window."""

import bisect
import json
import os
import sys
import time
from collections import defaultdict

import torch

from . import trace

PREFIX = "biscuit."
# Device operations launched in these harness spans are the run's own
# read-back and final synchronize, not the port's.
HARNESS_STAGES = (trace.HARNESS_SPAN + "readback",
                  trace.HARNESS_SPAN + "sync")


def _is_stage(name: str) -> bool:
    """A stage of the serving call or the training step: a span
    ``serve.<x>`` or ``train.<x>``, which together hold the call's work."""
    parts = name[len(PREFIX):].split(".")
    return name.startswith(PREFIX) and len(parts) == 2 and \
        parts[0] in ("serve", "train")


def attribute(prof) -> dict:
    """``spans``: for each span name of the window's thread, ``n`` (its
    occurrences in the window), ``host_s`` and ``device_s`` (inclusive);
    ``device_s``: the window's device time; ``coverage``: the share of it
    that the stages and the harness's read-back and synchronize hold;
    ``outside``: the device operations no stage holds, by name."""
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in events if e.device_type() == cpu}
    launch_at, op_at = {}, {}
    spans = defaultdict(list)
    device = []
    window = None
    for e in events:
        kind = trace._kind(e, cpu)
        if e.device_type() != cpu and (
                e.name() in host_names or kind == "gpu_user_annotation"):
            continue
        if e.device_type() == cpu:
            start, end = e.start_ns(), e.end_ns()
            if kind in ("cuda_runtime", "cuda_driver"):
                launch_at[e.correlation_id()] = start
                continue
            if e.linked_correlation_id() == 0:
                op_at[e.correlation_id()] = start
            name = e.name()
            if name == trace.WINDOW_SPAN:
                window = (start, end, e.start_thread_id())
            elif name.startswith(PREFIX) or name in HARNESS_STAGES:
                spans[(e.start_thread_id(), name)].append((start, end))
        elif kind in trace.DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the traced run has no window span")
    w0, w1, main = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    dur = [min(e, w1) - max(s, w0) for s, e, *_ in device]
    launched = [launch_at.get(corr, op_at.get(linked))
                for _, _, _, corr, linked in device]

    out, owned = {}, {}
    for (tid, name), occ in spans.items():
        occ = sorted(o for o in occ if o[1] > w0 and o[0] < w1)
        if tid != main or not occ:
            continue
        starts = [s for s, _ in occ]
        mine = set()
        for i, t in enumerate(launched):
            j = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if j >= 0 and t <= occ[j][1]:
                mine.add(i)
        owned[name] = mine
        if name.startswith(PREFIX):
            out[name[len(PREFIX):]] = {
                "n": len(occ),
                "host_s": sum(min(e, w1) - max(s, w0) for s, e in occ)
                * 1e-9,
                "device_s": sum(dur[i] for i in mine) * 1e-9}
    covered = set()
    for name, mine in owned.items():
        if _is_stage(name) or name in HARNESS_STAGES:
            covered |= mine
    total = sum(dur)
    rest = defaultdict(int)
    for i, d in enumerate(device):
        if i not in covered:
            rest[d[2][:trace.NAME_CHARS]] += dur[i]
    return {"spans": out, "device_s": total * 1e-9,
            "coverage": (sum(dur[i] for i in covered) / total if total
                         else None),
            "outside": [[n, v * 1e-9] for n, v in
                        sorted(rest.items(), key=lambda kv: -kv[1])[:8]]}


# Each number: what it reads of which span. Seconds become ms per request
# or per step completed (``Run.items``); ``gbps`` is the serving copy's
# bytes (each occurrence a request of uint8 tiles of the configuration's
# size) over its device seconds.
NUMBERS = {
    "copy_ms.serve": ("device_s", "serve.copy"),
    "copy_host_ms.serve": ("host_s", "serve.copy"),
    "copy_gbps.serve": ("gbps", "serve.copy"),
    "entry_flow_ms.serve": ("device_s", "trunk.entry"),
    "copy_host_ms.train": ("host_s", "train.copy"),
    "augment_ms.train": ("device_s", "train.augment"),
    "forward_ms.train": ("device_s", "train.forward"),
    "backward_ms.train": ("device_s", "train.backward"),
    "optimizer_ms.train": ("device_s", "train.optimizer"),
}


def numbers(spans: dict, run) -> dict:
    """The values of ``NUMBERS`` of the run's entry that its spans give."""
    out = {}
    for name, (what, span) in NUMBERS.items():
        x = spans.get(span)
        if not name.endswith("." + run.entry) or x is None or not run.items:
            continue
        if what != "gbps":
            out[name] = x[what] / run.items * 1e3
        elif x["device_s"] > 0:
            px = run.cell.config["hp"]["tile_px"]
            tiles = x["n"] * run.cell.traffic["tiles_per_request"]
            out[name] = tiles * px * px * 3 / x["device_s"] * 1e-9
    return out


def run_cell(cell, seed: int, seconds: float, device, t_proc: float):
    """One traced run of ``cell`` through ``drive.execute``: (its result
    line, the report of its program spans). The profiler's events and the
    run's ``Run`` are taken on their way to ``trace.summarize`` and the
    metric readers, and the harness is left as it was."""
    from . import drive

    got = {}
    summarize, drivers = trace.summarize, dict(drive.DRIVERS)

    def keep_events(prof, bounds):
        got["attributed"] = attribute(prof)
        return summarize(prof, bounds)

    def keep_run(entry):
        def run(*args, **kwargs):
            out = drivers[entry](*args, **kwargs)
            got["run"] = out.run
            return out
        return run

    trace.summarize = keep_events
    drive.DRIVERS.update({k: keep_run(k) for k in drivers})
    try:
        line, _ = drive.execute(cell, seed, seconds, True, device, t_proc)
    finally:
        trace.summarize = summarize
        drive.DRIVERS.update(drivers)
    run, report = got["run"], got["attributed"]
    report = {"cell": cell.name, "seed": seed, "items": run.items,
              "numbers": numbers(report["spans"], run), **report}
    return line, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cell_name, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    for key in [k for k in os.environ if k.startswith("BISCUIT_")]:
        del os.environ[key]
    t_proc = time.perf_counter()
    from . import spec

    line, report = run_cell(spec.load_cell(cell_name), seed, seconds,
                            torch.device("cuda", 0), t_proc)
    print(json.dumps(line))
    print("program_spans", json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
