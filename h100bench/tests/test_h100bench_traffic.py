"""Seeded traffic and weights repeat exactly; other seeds change the
content, never the sizes."""

import json

import numpy as np
import torch

from h100bench.harness import spec
from h100bench.harness.traffic import Stream, tile_pool
from h100bench.harness.weights import make
from h100bench.reference.params import param_specs
from h100bench.tests import tiny

BIG = 2 ** 31 + 11


def test_tile_pool_repeats_exactly():
    a = tile_pool(6, 37, BIG, "cpu", block=4)
    b = tile_pool(6, 37, BIG, "cpu", block=4)
    c = tile_pool(6, 37, BIG + 1, "cpu", block=4)
    assert a.dtype == np.uint8 and a.shape == (6, 37, 37, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # tissue-like: every tile has texture, none is flat
    assert (a.reshape(6, -1).std(axis=1) > 5).all()


def test_stream_items_repeat_and_keep_their_sizes():
    for mix in ("serve_closed_b256", "train_steps_b128"):
        tr = tiny.traffic(mix)
        cfg = tiny.config("xception299-nature2022", tr["entry"])
        s1, s2 = (Stream(tr, cfg, BIG, "cpu") for _ in range(2))
        s3 = Stream(tr, cfg, 7, "cpu")
        for i in range(5):
            assert np.array_equal(s1.slice(i), s2.slice(i))
            assert s1.seed(i) == s2.seed(i) != s3.seed(i)
            assert s1.slice(i).shape == s3.slice(i).shape
        assert np.array_equal(s1.labels, s2.labels)


def test_items_are_different_slices():
    tr = json.loads((spec.BENCH_DIR / "traffic" / "serve_closed_b256.json")
                    .read_text())
    size = tr["tiles_per_request"]
    starts = {(i * size) % (tr["pool_tiles"] - size + 1)
              for i in range(1500)}
    assert len(starts) == 1500
    tr = json.loads((spec.BENCH_DIR / "traffic" / "train_steps_b128.json")
                    .read_text())
    first = [(i * tr["batch"]) % (tr["pool_tiles"] - tr["batch"] + 1)
             for i in range(tr["checked_steps"])]
    rows = [set(range(s, s + tr["batch"])) for s in first]
    assert all(not (a & b) for i, a in enumerate(rows) for b in rows[i + 1:])


def test_weights_repeat_and_follow_the_specs():
    cfg = tiny.config("resnet50-nature2022")
    a, b = make(cfg, BIG, "cpu"), make(cfg, BIG, "cpu")
    c = make(cfg, BIG + 1, "cpu")
    specs = param_specs(cfg)
    assert list(a) == [n for n, _, _ in specs]
    for name, shape, role in specs:
        assert tuple(a[name].shape) == tuple(shape)
        assert torch.equal(a[name], b[name])
        if role == "conv":
            assert not torch.equal(a[name], c[name])
            bound = 2 * (torch.tensor(shape[1:]).prod().item() ** -0.5
                         / 0.8796256610342398)
            assert a[name].abs().max() <= bound * (1 + 1e-5)
        if role in ("bn_weight", "bn_var"):
            assert 0.8 <= a[name].min() and a[name].max() <= 1.2
