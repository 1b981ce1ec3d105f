"""The metric arithmetic on a synthetic timeline: busy and idle time,
each wrapper's kernels found by its span, the sum of least times over the
sum of device times, the library's share, and the tail over every
request."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100bench.harness import spec, trace
from h100bench.harness.drive import Run

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, kind, dev, start, end, corr=0, linked=0,
                 thread=1):
        self._v = (name, kind, dev, start, end, corr, linked, thread)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


US = 1000


def timeline():
    """A 1-ms window: two head calls (each launching one kernel of 100 and
    150 us), a library kernel of 200 us and a copy of 50 us; the host in
    'readback' for the gap at 500-700 us."""
    ev = [Ev("h100bench.window", "user_annotation", CPU, 0, 1000 * US),
          Ev("h100bench.call", "user_annotation", CPU, 0, 300 * US, 10),
          Ev("h100bench.readback", "user_annotation", CPU, 400 * US,
             1000 * US, 11),
          Ev("aten::copy_", "cpu_op", CPU, 450 * US, 990 * US, 12),
          Ev("h100bench.kernel:mcd_head", "user_annotation", CPU, 10 * US,
             20 * US, 13),
          Ev("h100bench.kernel:mcd_head", "user_annotation", CPU, 30 * US,
             40 * US, 14),
          Ev("cudaLaunchKernel", "cuda_runtime", CPU, 15 * US, 16 * US, 1,
             13, 77),
          Ev("cudaLaunchKernel", "cuda_runtime", CPU, 35 * US, 36 * US, 2,
             14, 77),
          Ev("cudaLaunchKernel", "cuda_runtime", CPU, 50 * US, 51 * US, 3,
             10, 77),
          Ev("head_kernel", "kernel", CUDA, 100 * US, 200 * US, 1, 13),
          Ev("head_kernel", "kernel", CUDA, 200 * US, 350 * US, 2, 14),
          Ev("conv_kernel", "kernel", CUDA, 350 * US, 500 * US, 3, 10),
          Ev("conv_kernel", "kernel", CUDA, 700 * US, 750 * US, 3, 10),
          Ev("Memcpy DtoH", "gpu_memcpy", CUDA, 750 * US, 800 * US, 4, 11),
          # the spans' shadows on the device's timeline
          Ev("h100bench.call", "gpu_user_annotation", CUDA, 100 * US,
             500 * US),
          Ev("h100bench.kernel:mcd_head", "gpu_user_annotation", CUDA,
             100 * US, 350 * US)]
    return ev


def test_summary_of_a_synthetic_timeline():
    s = trace.summarize(_prof(timeline()), {"mcd_head": [50e-6, 75e-6]})
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(500e-6)           # 100-500, 700-800
    assert s.kernel_s == pytest.approx(450e-6)
    assert s.library_s == pytest.approx(200e-6)
    assert s.calls["mcd_head"] == [(50e-6, pytest.approx(100e-6)),
                                   (75e-6, pytest.approx(150e-6))]
    assert s.device_ops[0] == ["head_kernel", pytest.approx(250e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["readback / aten::copy_"] == pytest.approx(400e-6)
    assert gaps["call"] == pytest.approx(100e-6)


class EvNoKind(Ev):
    activity_type = None


def test_activity_types_read_without_the_profilers_field():
    old = [EvNoKind(*e._v) for e in timeline()]
    a = trace.summarize(_prof(timeline()), {"mcd_head": [50e-6, 75e-6]})
    b = trace.summarize(_prof(old), {"mcd_head": [50e-6, 75e-6]})
    assert a == b


def test_span_and_count_must_agree():
    with pytest.raises(RuntimeError):
        trace.summarize(_prof(timeline()), {"mcd_head": [50e-6]})


def _run(entry, **kw):
    cell = SimpleNamespace(entry=entry, config={})
    base = dict(setup_s=1.0, window_s=2.0, items=4, tiles=1024)
    base.update(kw)
    return Run(cell, **base)


def test_readers_on_the_synthetic_timeline():
    s = trace.summarize(_prof(timeline()), {"mcd_head": [50e-6, 75e-6]})
    run = _run("serve", trace=s, call_s=[0.003, 0.001, 0.002, 0.010],
               latency_s=[i / 1000 for i in range(1, 101)])
    assert spec.reader("mcd_head_roofline")(run) == pytest.approx(50.0)
    assert spec.reader("fused_middle_flow_roofline")(run) is None
    assert spec.reader("idle.serve")(run) == pytest.approx(50.0)
    assert spec.reader("idle.train")(run) is None
    assert spec.reader("library_ms.serve")(run) == pytest.approx(0.05)
    assert spec.reader("enqueue_ms.serve")(run) == pytest.approx(2.5)
    assert spec.reader("serve_tiles_per_s")(run) == pytest.approx(512.0)
    # the tail of every request: 95th percentile of 1..100 ms
    assert spec.reader("serve_p95_ms")(run) == pytest.approx(
        float(np.percentile(np.arange(1, 101), 95)))
    assert spec.reader("setup_s")(run) == 1.0


def test_innermost_pieces():
    pieces = trace._innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                               (6, 8, "d")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                      (6, 8, "d"), (8, 10, "a")]
