"""The toy trunk family's cells for the CPU tests (``toy_family.py``): its
configuration, mixes, workloads and family file written into a directory
of their own, and the port-side model the tests put in ``build_model``'s
place, a small module that loads the same ``state_dict`` (the port has
no such trunk)."""

import json

import torch
from torch import nn

from h100bench.tests import tiny

ARCHS = {"toy_tiny": {"patch": 4, "width": 16, "features": 32}}
GROUPS = {"stem": ["backbone.patch"], "trunk": ["backbone.norm",
                                                "backbone.proj"],
          "head": ["head."]}
CELLS = {"serve": "toy.serve.tiny", "train": "toy.train.tiny"}
MIXES = {"serve": "serve_closed_b256", "train": "train_steps_b128"}


def config(entry: str) -> dict:
    cfg = tiny.config("xception299-nature2022", entry)
    del cfg["counts"]                # no FLOP count: untraced runs only
    cfg.update(name=f"toy-tiny-{entry}", source="a test-only toy trunk",
               arch={"family": "toy", **ARCHS["toy_tiny"]},
               leaf_groups=GROUPS,
               serving={"use_kernel": True, "fused_trunk": None,
                        "fuse_blocks": False})
    cfg["hp"]["model"] = "toy_tiny"
    return cfg


def write(root):
    """Write both toy cells and the family under ``root``; returns the
    manifest with the cells in its metrics' lists."""
    from h100bench.harness import spec

    fam = root / "reference" / "families"
    fam.mkdir(parents=True, exist_ok=True)
    (fam / "toy.py").write_text(
        (spec.BENCH_DIR / "tests" / "toy_family.py").read_text())
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    bench = spec.manifest()
    for entry, name in CELLS.items():
        cfg = config(entry)
        mix = f"{MIXES[entry]}-tiny"
        (root / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        (root / "traffic" / f"{mix}.json").write_text(
            json.dumps(tiny.traffic(MIXES[entry])))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"name": name, "config": cfg["name"], "traffic": mix,
             "chips": 1, "limits": tiny.LIMITS[entry, "toy"]}))
        for m in bench["end_to_end"]:
            if any(c.startswith(f"xception299.{entry}.")
                   for c in m.get("workloads", ())):
                m["workloads"].append(name)
    return bench


class ToyClassifier(nn.Module):
    """The toy trunk as a port model: ``features`` of NHWC tiles, the
    port's MC-dropout head, the module path in training."""

    def __init__(self, hp):
        super().__init__()
        from biscuit_torch.models.xception import Head

        a = ARCHS[hp.model]
        self.arch, self.dropout = hp.model, hp.dropout
        self.compute_dtype = torch.float32
        self.backbone = nn.Module()
        self.backbone.patch = nn.Conv2d(3, a["width"], a["patch"],
                                        stride=a["patch"])
        self.backbone.norm = nn.LayerNorm(a["width"], eps=1e-6)
        self.backbone.proj = nn.Linear(a["width"], a["features"])
        self.head = Head(a["features"], 2, hp.hidden_layers,
                         hp.hidden_layer_width, hp.dropout)

    def features(self, x):
        b = self.backbone
        h = b.patch(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        return nn.functional.gelu(b.proj(b.norm(h))).mean(dim=1)

    def head_logits(self, feats, mc_dropout=False, generator=None):
        return self.head(feats, mc_dropout, generator)

    def forward(self, x, mc_dropout=False, generator=None, rows=None):
        return self.head(self.features(x), mc_dropout, generator, rows)


def build_model(hp):
    return ToyClassifier(hp)


def port(module: str):
    """The stand-in for the program's modules that ``port_arch`` reads."""
    if module != "models.toy":
        raise ModuleNotFoundError(module)
    import sys

    return sys.modules[__name__]
