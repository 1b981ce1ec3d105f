"""The reference against the port's CPU path at a tiny size (the tests may
import the port; the reference may not)."""

import json
import time

import pytest
import torch

from h100bench.harness import check, drive, spec
from h100bench.harness.traffic import tile_pool
from h100bench.harness.weights import make
from h100bench.reference import nets, philox, preprocess
from h100bench.reference.params import param_specs, trainable
from h100bench.tests import tiny


@pytest.mark.parametrize("config", ["xception299-nature2022",
                                    "resnet50-nature2022"])
def test_param_specs_are_the_ports_state_dict(config):
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model

    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json")
                     .read_text())
    with torch.device("meta"):
        model = build_model(ModelParams.from_dict(cfg["hp"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in param_specs(cfg)} == want


@pytest.mark.parametrize("config", ["xception299-nature2022",
                                    "resnet50-nature2022"])
def test_leaf_groups_partition_the_trainable_leaves(config):
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json")
                     .read_text())
    leaves = trainable(param_specs(cfg))
    groups = check.group_leaves(leaves, cfg["leaf_groups"])
    assert sorted(n for g in groups.values() for n in g) == sorted(leaves)
    assert all(groups.values())


def test_preprocess_is_the_ports_f32_chain():
    from biscuit_torch.data.normalize import (
        ReinhardFastNormalizer,
        per_image_standardization,
    )

    x = torch.as_tensor(tile_pool(4, 37, 3, "cpu"))
    port = per_image_standardization(ReinhardFastNormalizer()(x.float()))
    ref = preprocess.preprocess(x, "reinhard_fast")
    assert (port - ref).abs().max() < 1e-4


def test_dropout_stream_is_the_heads():
    from biscuit_torch.ops.mcd_head import _threshold, philox_dropout_bits

    seed = (2 ** 31 + 9) << 24 | 5
    bits = philox_dropout_bits(seed, 3, 1, 10, 36)
    keep = philox.keep_masks(seed, 3, 1, range(0, 10), 36, 0.1, "cpu")
    assert torch.equal(keep, bits >= _threshold(0.1))
    part = philox.keep_masks(seed, 3, 1, range(4, 10), 36, 0.1, "cpu")
    assert torch.equal(part, keep[:, 4:])


@pytest.mark.parametrize("config", ["xception299-nature2022",
                                    "resnet50-nature2022"])
@pytest.mark.parametrize("train", [False, True])
def test_features_match_the_ports_f32_model(config, train):
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model

    cfg = tiny.config(config)
    w = make(cfg, 11, "cpu")
    model = build_model(ModelParams.from_dict(cfg["hp"]))
    model.load_state_dict(w)
    model.train(train)
    x = preprocess.preprocess(torch.as_tensor(tile_pool(4, 37, 2, "cpu")),
                              "reinhard_fast")
    with torch.no_grad():
        port = model.features(x)
        ref = nets.features(x, w, cfg, train=train)
    assert (port - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("cell", ["xception299.serve.b256",
                                  "xception299.train.b128",
                                  "resnet50.serve.b256",
                                  "resnet50.train.b128"])
def test_tiny_runs_are_correct(cell, tmp_path):
    bench, names = tiny.write(tmp_path, (cell,))
    c = tiny.load(tmp_path, bench, names[cell])
    torch.set_num_threads(2)
    for seed in (2 ** 31 + 3, 17):
        line, record = drive.execute(c, seed, 0.3, False,
                                     torch.device("cpu"), time.perf_counter())
        assert line["correct"], line["checks"]
        assert set(record["readings"]) == check.givable(c.entry, c.config)
        assert line["attempted"] > 0 and line["failed"] == 0
        assert list(line)[-1] == "checks"
        names = {m["name"] for m in c.end_to_end}
        assert set(line["metrics"]) == names
    line, _ = drive.execute(c, 5, 0.3, True, torch.device("cpu"),
                            time.perf_counter())
    assert line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
