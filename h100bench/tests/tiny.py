"""Tiny cells for the CPU tests: the shipped mixes and limits at a size a
test run holds, on the port's CPU path (its kernels' plain versions),
written as files into a directory of their own."""

import copy
import json

from h100bench.harness import spec

XCEPTION_TINY = {"family": "xception", "entry_convs": [8, 16],
                 "entry_blocks": [16, 32, 48], "middle_repeats": 2,
                 "middle_width": 48, "exit_block": [48, 64],
                 "exit_convs": [96, 128]}
RESNET_TINY = {"family": "resnet", "block": "basic", "repeats": [1, 1, 1, 1],
               "stem": 8}


def config(base: str, entry: str = "serve") -> dict:
    cfg = copy.deepcopy(json.loads(
        (spec.BENCH_DIR / "configs" / f"{base}.json").read_text()))
    xception = cfg["arch"]["family"] == "xception"
    cfg["name"] = f"{base}-tiny-{entry}"
    cfg["arch"] = XCEPTION_TINY if xception else RESNET_TINY
    # f32, and for training 64 px and batches of 8: smaller, a train-mode
    # BatchNorm over a few values amplifies rounding past any useful limit.
    cfg["hp"].update(model="xception_tiny" if xception else "resnet_tiny",
                     tile_px=37 if entry == "serve" else 64,
                     hidden_layer_width=32, uq_samples=4,
                     compute_dtype="float32")
    cfg["serving"] = {"use_kernel": True, "fused_trunk": xception,
                      "fuse_blocks": False}
    return cfg


def traffic(mix: str) -> dict:
    t = json.loads((spec.BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    if t["entry"] == "serve":
        t.update(tiles_per_request=4, pool_tiles=16, warm_requests=1,
                 check_requests=2)
    else:
        t.update(batch=8, pool_tiles=32)
    return t


# The numbers the full-size cells compare, with limits set from eight
# seeds of each tiny cell on the CPU (program's largest / control's
# smallest over three seeds): Xception serving mean (logit units) 0.0047 /
# 0.049, std 0.0007 / 0.0043; ResNet serving 0.045 / 0.19, 0.0027 /
# 0.0096. Training, Xception / ResNet: Xception's median leaf's first
# gradient 0.0011 / 0.042; worst leaf's change 0.039 / 0.105 (the control
# fails the others); ResNet's change up to 0.072 on a seed where the f32
# rounding of the preprocess (1e-5 of the standardized tile) moves the
# first block's BatchNorm; Adam's second moment, median leaf 0.012 / 0.073
# and 0.010 / 0.058; the running statistics' worst leaf 0.00014 / 0.032
# and 0.00048 / 0.020; the first gradient's median leaf of each group,
# Xception stem 0.0043 / 0.21, entry 0.0017 / 0.057, middle 0.0009 /
# 0.056, exit 0.0008 / 0.037, head 1e-5 / 0.051; ResNet stage0 0.021 /
# 0.074, stage1 0.0096 / 0.052, stage2 0.0070 / 0.052, stage3 0.0054 /
# 0.017, head 1e-5 / 0.046. The toy family (``toy.py``; 12 seeds, 5 of the
# control): serving mean 0.026 / 0.12, std 0.0022 / 0.022; training, all
# in f32 with no BatchNorm, under 5e-5 on every number against the
# control's change 0.029, second moment 0.017, first gradient stem 0.0062,
# trunk 0.0075, head 0.011; each fault reads 0.04 or more on the number
# that catches it.
_TRAIN = {"change_gap": 0.11, "adam_v_median_gap": 0.03,
          "running_gap": 0.005}
LIMITS = {("serve", "xception"): {"mean_logit_gap": 0.02, "std_gap": 0.002},
          ("serve", "resnet"): {"mean_logit_gap": 0.1, "std_gap": 0.006},
          ("train", "xception"): {
              "grad1_median_gap": 0.01, **_TRAIN,
              "grad1_gap.stem": 0.05, "grad1_gap.entry": 0.02,
              "grad1_gap.middle": 0.02, "grad1_gap.exit": 0.015,
              "grad1_gap.head": 0.015},
          ("train", "resnet"): {
              **_TRAIN, "grad1_gap.stage0": 0.045,
              "grad1_gap.stage1": 0.025, "grad1_gap.stage2": 0.025,
              "grad1_gap.stage3": 0.011, "grad1_gap.head": 0.015},
          ("serve", "toy"): {"mean_logit_gap": 0.06, "std_gap": 0.006},
          ("train", "toy"): {"change_gap": 0.003, "adam_v_median_gap": 0.002,
                             "grad1_gap.stem": 0.001,
                             "grad1_gap.trunk": 0.001,
                             "grad1_gap.head": 0.001}}


def write(root, cells=("xception299.serve.b256", "xception299.train.b128",
                       "resnet50.serve.b256", "resnet50.train.b128")):
    """Write tiny twins of ``cells`` under ``root``; returns (manifest,
    {cell: tiny cell name})."""
    bench = spec.manifest()
    names = {}
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for cell in cells:
        w = json.loads((spec.BENCH_DIR / "workloads" / f"{cell}.json")
                       .read_text())
        tr = traffic(w["traffic"])
        cfg = config(w["config"], tr["entry"])
        name = f"{cell}.tiny"
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (root / "traffic" / f"{w['traffic']}-tiny.json").write_text(
            json.dumps(tr))
        w.update(name=name, config=cfg["name"], traffic=f"{w['traffic']}-tiny",
                 limits=LIMITS[tr["entry"], cfg["arch"]["family"]])
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
        names[cell] = name
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(name)
    return bench, names


def load(root, bench, name):
    return spec.load_cell(name, base=root, bench=bench)
