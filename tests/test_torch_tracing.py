"""The port's spans and counters (biscuit_torch/tracing.py) on the CPU.

A span is a ``record_function`` event only while the profiler records on
the calling thread and nothing traces the code; otherwise it is one
shared null context. The serving call and the training step of an
``xception_tiny`` model record exactly the spans ``tracing`` names,
nested as it lists them; an export under the profiler records none. The
counters hold under threads, and ``ops/_build``'s launch counts are
their ``launch.<kernel>`` view.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biscuit_torch import tracing
from biscuit_torch.data.normalize import make_normalizer
from biscuit_torch.data.pipeline import PrefetchBatcher
from biscuit_torch.hp import ModelParams
from biscuit_torch.models.xception import build_model
from biscuit_torch.ops import _build
from biscuit_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    save_checkpoint,
)
from biscuit_torch.train.uq import UncertaintyInterface

PX = 32


def _hp(**kw):
    return ModelParams(model="xception_tiny", tile_px=PX, tile_um=PX,
                       hidden_layer_width=32, compute_dtype="float32", **kw)


def _model(hp):
    torch.manual_seed(0)
    return build_model(hp).eval()


def _tiles(n=4):
    return np.random.default_rng(0).integers(0, 256, (n, PX, PX, 3),
                                             dtype=np.uint8)


def _spans(prof):
    """The window's program spans: (start, end, name) in start order."""
    cut = len(tracing.PREFIX)
    out = [(e.time_range.start, e.time_range.end, e.name[cut:])
           for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    return sorted(out)


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_off_span_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("serve.copy") is tracing._OFF
    assert tracing.span("train.forward") is tracing._OFF
    with tracing.span("serve.copy") as entered:
        assert entered is None


def test_span_under_the_profiler_is_a_named_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = tracing.span("serve.head")
        assert ctx is not tracing._OFF
        with ctx:
            torch.ones(3).sum()
    assert [s[2] for s in _spans(prof)] == ["serve.head"]


def test_spans_are_off_in_a_thread_the_profiler_was_not_started_on():
    seen = []

    def other():
        seen.append(tracing.span("batcher.wait") is tracing._OFF)
        with tracing.span("batcher.wait"):
            torch.ones(2).sum()

    def run():
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    assert _profiled(run) == []
    assert seen == [True]


@pytest.mark.parametrize("route", ["module", "fused", "fuse_blocks"])
def test_serving_call_records_its_spans_nested(route):
    hp = _hp()
    ui = UncertaintyInterface.from_model(
        _model(hp), hp, k=3, device="cpu", fused_trunk=route != "module",
        fuse_blocks=route == "fuse_blocks")
    tiles = _tiles()
    ui(tiles)                                   # weights stacked, warm
    spans = _profiled(lambda: ui(tiles, seed=1))
    names = [s[2] for s in spans]
    trunk = [] if route == "module" else ["trunk.entry", "trunk.middle",
                                          "trunk.exit"]
    assert names == (["serve.copy", "serve.preprocess", "serve.trunk"]
                     + trunk + ["serve.head"])
    by = {s[2]: s for s in spans}
    for name in trunk:
        assert _inside(by[name], by["serve.trunk"])
    order = [by[n] for n in ("serve.copy", "serve.preprocess",
                             "serve.trunk", "serve.head")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("fused_trunk", [False, True])
def test_train_step_records_its_spans_in_order(fused_trunk):
    hp = _hp(dropout=0.1)
    model = _model(hp)
    step = make_train_step(model, make_optimizer(hp, model.parameters()),
                           hp, make_normalizer(hp.normalizer),
                           fused_trunk=fused_trunk, device="cpu")
    rng = np.random.default_rng(1)
    batch = (_tiles(4), rng.integers(0, 2, 4), np.ones(4, np.float32))
    step(*batch, torch.Generator().manual_seed(0))
    spans = _profiled(lambda: step(*batch, torch.Generator().manual_seed(1)))
    assert [s[2] for s in spans] == [
        "train.copy", "train.optimizer", "train.augment", "train.forward",
        "train.backward", "train.optimizer"]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


class _Batches(list):
    def close(self):
        pass


def test_batcher_wait_is_a_span_a_batch():
    batches = _Batches({"i": i} for i in range(3))
    batcher = PrefetchBatcher(batches, depth=2)
    try:
        got = []
        spans = _profiled(lambda: got.extend(batcher))
    finally:
        batcher.close()
    assert got == batches
    # one wait a batch, and one for the end of the stream
    assert [s[2] for s in spans] == ["batcher.wait"] * 4


def test_export_under_the_profiler_records_no_span(tmp_path):
    from biscuit_torch import serve

    hp = _hp(uq=True, uq_samples=2)
    path = save_checkpoint(str(tmp_path), _model(hp), hp, 1, "y", "t", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        art = serve.export_servable(path, str(tmp_path / "s.biscuit"),
                                    batch_size=2, device="cpu",
                                    use_kernels=True, with_features=False)
    assert _spans(prof) == []
    mean, _ = serve.load_servable(art, device="cpu")(_tiles(2), seed=0)
    assert mean.shape == (2, 2)


def test_counters_hold_under_eight_threads():
    before = tracing.counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                tracing.count("test.threads")
                tracing.count("test.bytes", 3)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    counted = tracing.counts()
    assert counted["test.threads"] - before.get("test.threads", 0) == 16000
    assert counted["test.bytes"] - before.get("test.bytes", 0) == 48000


def test_launch_counts_are_the_launch_counters():
    _build.reset_launch_counts()
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}
    _build.count_launch("mcd_head")
    _build.count_launch("mcd_head")
    _build.count_launch("unit_bwd_strips")
    counted = _build.launch_counts()
    assert set(counted) == set(_build.KERNELS)
    assert counted["mcd_head"] == 2 and counted["unit_bwd_strips"] == 1
    assert sum(counted.values()) == 3
    assert tracing.counts()["launch.mcd_head"] == 2
    with pytest.raises(KeyError):
        _build.count_launch("no_such_kernel")
    _build.reset_launch_counts()
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}



def test_reset_launch_counts_zeroes_only_the_launch_counters():
    tracing.count("test.kept", 5)
    _build.count_launch("mcd_head")
    kept = tracing.counts()["test.kept"]
    _build.reset_launch_counts()
    assert _build.launch_counts()["mcd_head"] == 0
    assert tracing.counts()["test.kept"] == kept
    tracing.reset_counts("test.")
    assert "test.kept" not in tracing.counts()
