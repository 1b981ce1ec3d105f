"""The port's own spans (``biscuit.*``, ``biscuit_torch/tracing.py``) on
the synthetic timeline of ``test_h100bench_metrics``: every number the
summary gives is the same with and without them, and only the idle gaps
take their names. ``harness/program_spans`` puts each device operation
down to the spans it was launched in, inclusively and whatever thread
launched it, and runs a tiny cell with the harness left as it was."""

from types import SimpleNamespace

import pytest
import torch

from h100bench.harness import drive, program_spans, trace
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_metrics import (
    CPU,
    CUDA,
    US,
    Ev,
    _prof,
    timeline,
)

BOUNDS = {"mcd_head": [50e-6, 75e-6]}


def with_program_spans():
    """The timeline with the serving call's spans on the main thread (the
    copy, then the head around both head kernels' wrappers, whose launches
    another thread makes, over the middle of the bare 'call' gap at 0-100
    us) and one span of another thread over the 'readback' gap."""
    return timeline() + [
        Ev("biscuit.serve.copy", "user_annotation", CPU, 0, 8 * US, 20),
        Ev("biscuit.serve.head", "user_annotation", CPU, 9 * US, 60 * US,
           21),
        Ev("biscuit.batcher.wait", "user_annotation", CPU, 500 * US,
           990 * US, 22, thread=2)]


def test_program_spans_change_no_number_of_the_summary():
    plain = trace.summarize(_prof(timeline()), BOUNDS)
    spans = trace.summarize(_prof(with_program_spans()), BOUNDS)
    for field in ("window_s", "busy_s", "kernel_s", "library_s", "calls",
                  "device_ops"):
        assert getattr(spans, field) == getattr(plain, field), field
    assert sum(v for _, v in spans.idle_gaps) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))


def test_program_spans_name_the_idle_gaps():
    plain = dict(trace.summarize(_prof(timeline()), BOUNDS).idle_gaps)
    spans = dict(trace.summarize(_prof(with_program_spans()),
                                 BOUNDS).idle_gaps)
    assert "call" in plain and "call" not in spans
    assert spans["call / biscuit.serve.head"] == pytest.approx(
        plain["call"])
    # another thread's span names nothing: the main thread's op does
    assert spans["readback / aten::copy_"] == pytest.approx(
        plain["readback / aten::copy_"])


def with_a_nested_step():
    """The timeline with a training step's stages: ``train.backward``
    (60-300 us) of the main thread, inside it a span of another thread,
    and a kernel of 100 us that a second thread launches at 70 us; the
    conv kernel's launch at 50 us is in ``train.forward`` (40-55 us), and
    ``train.forward``'s nested ``trunk.entry`` holds it too."""
    return timeline() + [
        Ev("biscuit.train.forward", "user_annotation", CPU, 40 * US,
           55 * US, 30),
        Ev("biscuit.trunk.entry", "user_annotation", CPU, 45 * US,
           52 * US, 31),
        Ev("biscuit.train.backward", "user_annotation", CPU, 60 * US,
           300 * US, 32),
        Ev("biscuit.batcher.wait", "user_annotation", CPU, 60 * US,
           300 * US, 33, thread=2),
        Ev("cudaLaunchKernel", "cuda_runtime", CPU, 70 * US, 71 * US, 5,
           34, 2),
        Ev("bwd_kernel", "kernel", CUDA, 800 * US, 900 * US, 5, 34)]


def test_spans_hold_what_was_launched_in_them_inclusively():
    got = program_spans.attribute(_prof(with_a_nested_step()))
    spans = got["spans"]
    # the conv kernel (launched at 50 us): 150 us, then 50 us
    assert spans["train.forward"]["device_s"] == pytest.approx(200e-6)
    assert spans["trunk.entry"]["device_s"] == pytest.approx(200e-6)
    # launched from thread 2 while the main thread was in the backward
    assert spans["train.backward"]["device_s"] == pytest.approx(100e-6)
    assert spans["train.backward"]["host_s"] == pytest.approx(240e-6)
    assert spans["train.backward"]["n"] == 1
    # another thread's span is not the window's
    assert "batcher.wait" not in spans
    assert got["device_s"] == pytest.approx(600e-6)
    # stages hold conv and backward, the read-back span the DtoH copy;
    # the head kernels (launched in no stage) are outside
    assert got["coverage"] == pytest.approx(350e-6 / 600e-6)
    assert got["outside"] == [["head_kernel", pytest.approx(250e-6)]]


def _run(entry, items=2):
    cell = SimpleNamespace(entry=entry, config={"hp": {"tile_px": 10}},
                           traffic={"tiles_per_request": 4})
    return SimpleNamespace(cell=cell, entry=entry, items=items)


def test_numbers_per_request_and_the_copy_bandwidth():
    spans = {"serve.copy": {"n": 2, "host_s": 4e-3, "device_s": 1e-6},
             "trunk.entry": {"n": 2, "host_s": 1e-3, "device_s": 6e-3}}
    got = program_spans.numbers(spans, _run("serve"))
    assert got["copy_ms.serve"] == pytest.approx(0.5e-3)
    assert got["copy_host_ms.serve"] == pytest.approx(2.0)
    assert got["entry_flow_ms.serve"] == pytest.approx(3.0)
    # 2 requests of 4 tiles of 10 x 10 x 3 bytes in 1 us
    assert got["copy_gbps.serve"] == pytest.approx(2.4)
    assert not any(k.endswith(".train") for k in got)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_an_absent_span_gives_no_number(entry):
    assert program_spans.numbers({}, _run(entry)) == {}
    assert program_spans.numbers(
        {"train.forward": {"n": 1, "host_s": 1.0, "device_s": 1.0}},
        _run("train", items=0)) == {}


@pytest.mark.parametrize("cell", ["xception299.serve.b256",
                                  "resnet50.train.b128"])
def test_a_tiny_cell_runs_with_its_spans(cell, tmp_path):
    bench, names = tiny.write(tmp_path, (cell,))
    c = tiny.load(tmp_path, bench, names[cell])
    summarize, drivers = trace.summarize, dict(drive.DRIVERS)
    line, report = program_spans.run_cell(c, 2 ** 31 + 31, 0.3,
                                          torch.device("cpu"), 0.0)
    assert trace.summarize is summarize and drive.DRIVERS == drivers
    assert line["correct"] and report["items"] > 0
    entry = c.entry
    stages = {"serve": ["serve.copy", "serve.preprocess", "serve.trunk",
                        "serve.head", "trunk.entry", "trunk.middle",
                        "trunk.exit"],
              "train": ["train.copy", "train.augment", "train.forward",
                        "train.backward", "train.optimizer"]}[entry]
    assert set(stages) == set(report["spans"])
    assert {k for k in program_spans.NUMBERS if k.endswith("." + entry)
            and program_spans.NUMBERS[k][0] == "host_s"} <= set(
                report["numbers"])
