"""The ViT family (``reference/families/vit.py``) as its cells run it: a
tiny ViT cell, its configuration written into a directory of the test's
own from the shipped one, driven through ``drive.execute`` on the CPU,
serving and training (``make_train_step`` on a model with no BatchNorm);
its runs are correct, every fault it can have, the fp8 control and one
block's MLP branch dropped in the port make a run incorrect. The shipped
configuration is the port's ``uni2_h``; the two counted functions read
their calls' shapes, count every block of a traced forward, and count
nothing in a program that has no ViT."""

import json
import time

import pytest
import torch

from h100bench import control
from h100bench.harness import check, drive, faults, spec
from h100bench.reference.params import param_specs, trainable
from h100bench.tests import tiny

SEED = 2 ** 31 + 61
CONFIG = "uni2h-vith14-nature2022"
TINY = {"family": "vit", "img_size": 32, "patch": 8, "width": 32,
        "depth": 2, "heads": 2, "mlp_hidden": 96, "reg_tokens": 2,
        "norm_eps": 1e-6, "layer_scale": True, "pool": "token"}
GROUPS = {"embed": ["backbone.cls_token", "backbone.reg_token",
                    "backbone.pos_embed", "backbone.patch."],
          "blocks": ["backbone.block"], "norm": ["backbone.norm."],
          "head": ["head."]}
CELLS = {"serve": "vit.serve.tiny", "train": "vit.train.tiny"}
MIXES = {"serve": "serve_closed_b256", "train": "train_steps_b128"}
# Readings over 12 seeds of the program and 5 of the fp8 control (the
# program's largest / the control's smallest). Serving, through the head
# kernel's plain version and its bf16 roundings: mean (logit units) 0.068 /
# 0.58, std 0.0043 / 0.0137. Training, all in f32 with no BatchNorm:
# under 8e-6 on every number but the change, 0.051 / 0.114, set by
# qkv.bias, whose key part has no gradient but round-off (softmax ignores
# a shift of every score of a query) and which Adam moves by its sign; the
# control's second moment 0.024, first gradient embed 0.024, blocks 0.026,
# norm 0.022, head 0.0060. So the change's limit only catches a leaf moved
# too far (``altered`` reads about 1), and the control fails the others.
LIMITS = {"serve": {"mean_logit_gap": 0.2, "std_gap": 0.009},
          "train": {"change_gap": 0.15, "adam_v_median_gap": 0.002,
                    "grad1_gap.embed": 0.002, "grad1_gap.blocks": 0.002,
                    "grad1_gap.norm": 0.002, "grad1_gap.head": 0.0005}}


def _write(root):
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    bench = spec.manifest()
    for entry, name in CELLS.items():
        cfg = json.loads((spec.BENCH_DIR / "configs" / f"{CONFIG}.json")
                         .read_text())
        cfg["name"] = f"vit-tiny-{entry}"
        cfg["arch"], cfg["leaf_groups"] = TINY, GROUPS
        cfg["hp"].update(model="vit_tiny", tile_px=TINY["img_size"],
                         hidden_layer_width=32, uq_samples=4,
                         compute_dtype="float32")
        cfg["serving"] = {"use_kernel": True, "fused_trunk": None,
                          "fuse_blocks": False}
        mix = f"{MIXES[entry]}-tiny"
        (root / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        (root / "traffic" / f"{mix}.json").write_text(
            json.dumps(tiny.traffic(MIXES[entry])))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"name": name, "config": cfg["name"], "traffic": mix,
             "chips": 1, "limits": LIMITS[entry]}))
        for m in bench["end_to_end"]:
            if any(c.startswith(f"xception299.{entry}.")
                   for c in m.get("workloads", ())):
                m["workloads"].append(name)
    return bench


@pytest.fixture
def vit_cells(tmp_path):
    torch.set_num_threads(2)
    bench = _write(tmp_path)
    return {entry: spec.load_cell(name, base=tmp_path, bench=bench)
            for entry, name in CELLS.items()}


def _run(cell, seed=SEED):
    return drive.execute(cell, seed, 0.3, False, torch.device("cpu"),
                         time.perf_counter())


def test_the_shipped_config_is_the_ports_uni2_h():
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model

    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{CONFIG}.json")
                     .read_text())
    assert cfg["hp"]["tile_px"] == cfg["arch"]["img_size"] == 224
    with torch.device("meta"):
        model = build_model(ModelParams.from_dict(cfg["hp"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = param_specs(cfg)
    assert {n: tuple(s) for n, s, _ in specs} == want
    groups = check.group_leaves(trainable(specs), cfg["leaf_groups"])
    assert all(groups.values())
    assert sum(len(g) for g in groups.values()) == len(trainable(specs))


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_vit_runs_are_correct(entry, vit_cells):
    c = vit_cells[entry]
    for seed in (SEED, 7):
        line, record = _run(c, seed)
        assert line["correct"], line["checks"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(record["readings"]) == check.givable(entry, c.config)
    assert "running_gap" not in record["readings"]


def _vit_faults():
    out = [("serve", f, None) for f in faults.FAULTS["serve"]]
    out += [("train", f, None) for f in faults.FAULTS["train"]
            if f not in ("scaled", "frozen_stats")]
    return out + [("train", "scaled", g) for g in GROUPS]


@pytest.mark.parametrize("entry, fault, group", _vit_faults())
def test_each_vit_fault_makes_the_run_incorrect(entry, fault, group,
                                                vit_cells):
    c = vit_cells[entry]
    assert fault in faults.applicable(entry, c.config)
    prefixes = c.config["leaf_groups"][group] if group else ()
    with faults.planted(entry, fault, prefixes):
        line, _ = _run(c)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_the_control_fails_the_vit_limits(entry, vit_cells):
    c = vit_cells[entry]
    ok, checks = check.judge(control.control_numbers(c, SEED, "cpu"),
                             c.limits)
    assert not ok, checks


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_a_dropped_mlp_branch_makes_the_run_incorrect(entry, vit_cells,
                                                      monkeypatch):
    from biscuit_torch.models import vit

    calls = []
    mlp = vit.swiglu_mlp

    def dropped(x, *weights):
        # The last block's MLP adds nothing to the residual stream.
        calls.append(1)
        out = mlp(x, *weights)
        return out * 0 if len(calls) % TINY["depth"] == 0 else out

    monkeypatch.setattr(vit, "swiglu_mlp", dropped)
    line, _ = _run(vit_cells[entry])
    assert calls and not line["correct"], line["checks"]


def test_the_vit_counts_read_the_call_shapes():
    from h100bench.counts import vit_attention, vit_mlp

    counts = spec.kernel_counts()
    assert counts["vit_attention"].TARGET == ("biscuit_torch.models.vit",
                                              "attention")
    assert counts["vit_mlp"].TARGET == ("biscuit_torch.models.vit",
                                        "swiglu_mlp")
    q = torch.empty((256, 24, 265, 64), dtype=torch.bfloat16, device="meta")
    t, by = vit_attention.call_bound((q, q, q), {})
    assert by == "bytes" and t == pytest.approx(
        4 * 256 * 24 * 265 * 64 * 2 / 3.35e12)
    x = torch.empty((256, 265, 1536), dtype=torch.bfloat16, device="meta")
    w1 = torch.empty((8192, 1536), dtype=torch.bfloat16, device="meta")
    t, by = vit_mlp.call_bound((x, w1, None, None, None), {})
    assert by == "operations" and t == pytest.approx(
        2 * 256 * 265 * (1536 * 8192 + 4096 * 1536) / 989e12)


def test_a_program_without_a_vit_has_nothing_to_count(monkeypatch):
    import importlib
    import importlib.util

    from h100bench.counts import vit_attention, vit_mlp

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None
                        if name == "biscuit_torch.models.vit" else real(name))
    try:
        for mod in (vit_attention, vit_mlp):
            del mod.TARGET          # a reload keeps the module's names
            assert not hasattr(importlib.reload(mod), "TARGET")
    finally:
        monkeypatch.undo()
        for mod in (vit_attention, vit_mlp):
            importlib.reload(mod)
    assert hasattr(vit_attention, "TARGET")


def test_a_traced_forward_counts_every_block(vit_cells):
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from h100bench.harness import trace

    hp = ModelParams.from_dict(vit_cells["serve"].config["hp"])
    model = build_model(hp).eval()
    with trace.wrapped(spec.kernel_counts()) as bounds, torch.no_grad():
        model.features(torch.zeros(2, 32, 32, 3))
    assert len(bounds["vit_attention"]) == len(bounds["vit_mlp"]) == \
        TINY["depth"]
