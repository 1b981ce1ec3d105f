"""Readings that the correctness limits are set from; never run by a
benchmark run.

    python3 h100bench/control.py --workload <cell> --program-seeds 1,2,.. \
        --control-seeds 7,8,9 [--fault-seeds 4,5,6] [--seconds 2]

For each program seed, one run of the cell as ``run.py`` makes it, with
a short window (the same set-up, call, feed, sample and comparison); for
each control seed, the reference computed one precision below the
configuration's (float8; ``reference/quant.py``) in the program's place,
compared with the f32 reference on the same inputs as a run compares
them; for each fault seed, a run with each of the cell's planted faults
(``harness/faults.py``) whose reading a check needs (training only: the
parameters left unchanged read 1 by the measure and need no run; the
``scaled`` fault once for each of the configuration's leaf groups;
``frozen_stats`` only where the model keeps running statistics, its skip
said on standard error otherwise). One JSON line a reading; all in one
process, so that the kernels load once."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_numbers(cell, seed, device):
    import numpy as np

    from h100bench import reference
    from h100bench.harness import check
    from h100bench.harness.seeds import derive
    from h100bench.harness.traffic import Stream
    from h100bench.harness.weights import make
    from h100bench.reference import serve as ref_serve
    from h100bench.reference import train as ref_train

    cfg, tr = cell.config, cell.traffic
    weights = make(cfg, seed, device)
    stream = Stream(tr, cfg, seed, device)
    with reference.exact():
        if cell.entry == "serve":
            warm = tr["warm_requests"]
            rng = np.random.default_rng(derive(seed, "check"))
            sample = sorted(int(i) for i in rng.choice(
                range(warm, warm + 40), size=tr["check_requests"],
                replace=False))
            out = {}
            for quant in (None, "fp8"):
                out[quant] = [ref_serve.request(
                    stream.slice(i), stream.seed(i), weights, cfg, device,
                    quant) for i in sample]
            return check.serve_numbers(out["fp8"], out[None])
        batches = [(*stream.batch(i), stream.seed(i))
                   for i in range(tr["checked_steps"])]
        ref = ref_train.steps(weights, cfg, batches, device)
        low = ref_train.steps(weights, cfg, batches, device, quant="fp8")
        return check.train_numbers(low, ref, cfg["leaf_groups"])


def planted_faults(cell):
    """(reading's name, fault, leaf prefixes) of each training fault whose
    reading a check needs; a fault that the cell's model cannot have is
    said on standard error to be skipped."""
    from h100bench.harness import faults

    kept = faults.applicable("train", cell.config)
    if "frozen_stats" not in kept:
        print(f"fault frozen_stats skipped: {cell.config['name']} keeps no "
              "running statistics", file=sys.stderr, flush=True)
    planted = [(f, f, ()) for f in ("half_batch", "altered", "frozen_stats")
               if f in kept]
    return planted + [(f"scaled.{g}", "scaled", prefixes) for g, prefixes
                      in cell.config["leaf_groups"].items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100bench.harness import drive, faults, spec

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)

    def emit(kind, seed, numbers, t0, extra=None):
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "numbers": numbers, "s": time.perf_counter() - t0,
                          **(extra or {})}), flush=True)

    for seed in _seeds(args.program_seeds):
        t0 = time.perf_counter()
        line, record = drive.execute(cell, seed, args.seconds, False,
                                     device, t0)
        emit("program", seed, record["readings"], t0,
             {"correct": line["correct"], "attempted": line["attempted"],
              "memory_peak_bytes": line["device"]["memory_peak_bytes"]})
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit("control_fp8", seed, control_numbers(cell, seed, device), t0)
    if cell.entry == "train":
        for kind, fault, prefixes in planted_faults(cell):
            for seed in _seeds(args.fault_seeds):
                t0 = time.perf_counter()
                with faults.planted("train", fault, prefixes):
                    _, record = drive.execute(cell, seed, 0.5, False, device,
                                              t0)
                emit(f"fault_{kind}", seed, record["readings"], t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
