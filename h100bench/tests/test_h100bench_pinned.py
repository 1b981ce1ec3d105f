"""What the benchmark's own arithmetic gives, pinned bit for bit: the
weights of both full configurations at seed 0, and the reference's
answers (each sampled request's mean and standard deviation; the first
training steps' norms) on the tiny cells. Reorganising the reference or
the weight maker must leave every digest as it is."""

import hashlib
import json

import pytest
import torch

from h100bench.harness import spec
from h100bench.harness.traffic import Stream
from h100bench.harness.weights import make
from h100bench.reference import serve as ref_serve
from h100bench.reference import train as ref_train
from h100bench.tests import tiny

SEED = 2 ** 31 + 57

WEIGHTS = {
    "xception299-nature2022":
        "99b312865eabc8767f1d5f1952e452c4caeb35b03015db3234182b707ec70b7b",
    "resnet50-nature2022":
        "f6b8537a55d4d6c28b93d4c9c2daa70d91a1929d8cc4553cc6f4f1d286caf52b",
}
REFERENCE = {
    "xception299.serve.b256":
        "fa07a0fe6b9ef6f8754015c2d8e4014496114cad5c04a9c300151ca4a1d685eb",
    "xception299.train.b128":
        "e9d11aaf4c674bd3bd04c6569a46c7d9023bae920f18c611cc419bd35357868d",
    "resnet50.serve.b256":
        "f15915fdbaa148870a89aef4005ecd985d10bf0e464c5287156294c09b78d6f0",
    "resnet50.train.b128":
        "eeb7b57199e8c97b51f22b8d1d3b05946ecc966656c35334ab52da728de3f0e1",
}


@pytest.fixture
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _digest(weights: dict) -> str:
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_weights_are_pinned(config):
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json")
                     .read_text())
    assert _digest(make(cfg, 0, "cpu")) == WEIGHTS[config]


def _reference_digest(c) -> str:
    weights = make(c.config, SEED, "cpu")
    stream = Stream(c.traffic, c.config, SEED, "cpu")
    h = hashlib.sha256()
    if c.entry == "serve":
        for i in range(2):
            mean, std = ref_serve.request(stream.slice(i), stream.seed(i),
                                          weights, c.config, "cpu")
            h.update(mean.tobytes())
            h.update(std.tobytes())
    else:
        out = ref_train.steps(weights, c.config,
                              [(*stream.batch(i), stream.seed(i))
                               for i in range(c.traffic["checked_steps"])],
                              "cpu")
        h.update(json.dumps(out, sort_keys=True).encode())
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(REFERENCE))
def test_reference_answers_are_pinned(cell, tmp_path, two_threads):
    bench, names = tiny.write(tmp_path, (cell,))
    c = tiny.load(tmp_path, bench, names[cell])
    assert _reference_digest(c) == REFERENCE[cell]
