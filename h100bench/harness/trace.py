"""Tracing of a ``--trace 1`` run: spans the harness places from its own
files, the profiler's device timeline, and their reduction.

``wrapped(counts)`` replaces, for the run, each kernel wrapper that a
``counts/`` module names (``TARGET``) by a function that opens a
``torch.profiler.record_function`` span ``h100bench.kernel:<name>``
around the call and records the call's least time (``call_bound``). A
device kernel whose launch falls inside such a span on the host is that
wrapper's; every other kernel is the library's. ``summarize`` reads the
profiler's events directly (no trace file is written) and returns the
window's busy time, each wrapper's calls as (least time, device time),
the library's kernel time, and the breakdown of device operations and
idle gaps."""

import bisect
import importlib
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

KERNEL_SPAN = "h100bench.kernel:"
HARNESS_SPAN = "h100bench."
WINDOW_SPAN = "h100bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160        # a device operation's name in the breakdown


def span(name: str):
    return torch.profiler.record_function(HARNESS_SPAN + name)


@contextmanager
def wrapped(counts: dict):
    """Within the block, each counted wrapper records its calls' least
    times into ``bounds[name]`` (the dict yielded), inside its span."""
    bounds = defaultdict(list)
    undo = []
    try:
        for name, mod in counts.items():
            module = importlib.import_module(mod.TARGET[0])
            orig = getattr(module, mod.TARGET[1])
            applies = getattr(mod, "applies", None)

            def wrapper(*args, _orig=orig, _name=name, _mod=mod,
                        _applies=applies, **kwargs):
                if _applies is not None and not _applies(args, kwargs):
                    return _orig(*args, **kwargs)
                bounds[_name].append(_mod.call_bound(args, kwargs)[0])
                with torch.profiler.record_function(KERNEL_SPAN + _name):
                    return _orig(*args, **kwargs)

            setattr(module, mod.TARGET[1], wrapper)
            undo.append((module, mod.TARGET[1], orig))
        yield bounds
    finally:
        for module, attr, orig in reversed(undo):
            setattr(module, attr, orig)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float                       # every kernel in the window
    library_s: float                      # kernels no wrapper launched
    calls: dict = field(default_factory=dict)   # name -> [(bound, device)]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class _Intervals:
    """Non-overlapping host intervals, found by the time they contain."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def find(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            s, e, tag = self.items[j]
            if s <= t <= e:
                return tag
        return None


def _kind(e, cpu) -> str:
    """The event's activity type: 'kernel', 'gpu_memcpy' or 'gpu_memset'
    on the device; 'cuda_runtime' (a launch or copy call, linked to the op
    that made it) or an op on the host. Read from the event where the
    profiler gives it, else from its device, name and link."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    if e.device_type() == cpu:
        return "cuda_runtime" if e.linked_correlation_id() > 0 else "cpu_op"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(prof, bounds: dict) -> Summary:
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    launch_at = {}            # correlation id -> host start (ns)
    op_at = {}                # frontend op correlation id -> host start
    spans_by_thread = defaultdict(list)
    ops_by_thread = defaultdict(list)
    kernel_spans = []
    device = []
    window = None
    # A span also shows on the device's timeline (a GPU user annotation)
    # under its host name; it is no device work.
    host_names = {e.name() for e in events if e.device_type() == cpu}
    for e in events:
        kind = _kind(e, cpu)
        if e.device_type() != cpu and (
                e.name() in host_names or kind == "gpu_user_annotation"):
            continue
        if e.device_type() == cpu:
            start, end = e.start_ns(), e.end_ns()
            if kind in ("cuda_runtime", "cuda_driver"):
                launch_at[e.correlation_id()] = start
                continue
            if e.linked_correlation_id() == 0:
                op_at[e.correlation_id()] = start
            name = e.name()
            if name.startswith(KERNEL_SPAN):
                kernel_spans.append((start, end, name[len(KERNEL_SPAN):]))
            elif name == WINDOW_SPAN:
                window = (start, end, e.start_thread_id())
            elif name.startswith(HARNESS_SPAN):
                spans_by_thread[e.start_thread_id()].append(
                    (start, end, name[len(HARNESS_SPAN):]))
            else:
                ops_by_thread[e.start_thread_id()].append((start, end, name))
        elif kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), e.name(), kind,
                           e.correlation_id(), e.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the traced run has no window span")
    w0, w1, main = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]

    # Each wrapper's calls, in call order, with the device time of the
    # kernels launched inside each.
    kernel_spans.sort()
    per_name = defaultdict(int)
    tagged = []
    for s, e, name in kernel_spans:
        tagged.append((s, e, (name, per_name[name])))
        per_name[name] += 1
    spans = _Intervals(tagged)
    device_s = defaultdict(float)
    kernel_ns = library_ns = 0
    by_op = defaultdict(int)
    for s, e, name, kind, corr, linked in device:
        dur = min(e, w1) - max(s, w0)
        by_op[name] += dur
        if kind != "kernel":
            continue
        kernel_ns += dur
        t = launch_at.get(corr, op_at.get(linked))
        owner = spans.find(t) if t is not None else None
        if owner is None:
            library_ns += dur
        else:
            device_s[owner] += dur * 1e-9
    calls = {}
    for name, bs in bounds.items():
        n = per_name.get(name, 0)
        if n != len(bs):
            raise RuntimeError(f"{name}: {len(bs)} calls counted, {n} spans "
                               f"traced")
        calls[name] = [(bs[i], device_s.get((name, i), 0.0))
                       for i in range(n)]

    # Busy time: the union of device activity inside the window; the gaps
    # named by what the host's main thread was doing at their middle.
    busy = 0
    gaps = defaultdict(float)
    harness = _Intervals(_innermost(spans_by_thread[main]))
    ops = _Intervals(_innermost(ops_by_thread[main]))
    cursor = w0

    def gap(a, b):
        mid = (a + b) // 2
        what = harness.find(mid) or "outside the harness's spans"
        op = ops.find(mid)
        gaps[f"{what} / {op}" if op else what] += (b - a) * 1e-9

    for s, e, *_ in sorted(device):
        s, e = max(s, w0), min(e, w1)
        if s > cursor:
            gap(cursor, s)
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gap(cursor, w1)
    return Summary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
        kernel_s=kernel_ns * 1e-9, library_s=library_ns * 1e-9, calls=calls,
        device_ops=[[n[:NAME_CHARS], v * 1e-9] for n, v in
                    sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[n, v] for n, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])


def _innermost(items):
    """Nested host intervals cut into non-overlapping pieces, each piece
    tagged with the innermost interval that covers it."""
    items = sorted(items, key=lambda x: (x[0], -x[1]))
    out = []
    stack = []
    cursor = None
    for s, e, name in items + [(float("inf"), float("inf"), None)]:
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if cursor < top[1]:
                out.append((cursor, top[1], top[2]))
                cursor = top[1]
        if name is None:
            break
        if stack and cursor < s:
            out.append((cursor, s, stack[-1][2]))
        stack.append((s, e, name))
        cursor = s
    return out
