"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference. ``execute`` returns the result line as a
dict; ``run.py`` prints it.

Serving (``entry: serve``): the port's ``UncertaintyInterface`` over the
configuration's model, driven by one closed-loop client: each request's
tiles go in as a numpy uint8 slice of the pool, with the request's seed,
and its mean and uncertainty are copied to the host before the next is
sent. Training (``entry: train``): the step that ``make_train_step``
returns, fed numpy batches from host memory, each with its own seeded
generator, dispatched without a synchronize; the window ends in one.

Set-up drives the entry with the window's own call and feed before the
window opens (the warm requests; the checked training steps), so that
every shape is warm and nothing compiles inside the window. The
reference runs after the window, once the peak memory has been read and
the program's state freed."""

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import reference
from ..reference import serve as ref_serve
from ..reference import train as ref_train
from . import check, spec, trace
from .seeds import derive
from .traffic import Stream
from .weights import make as make_weights


@dataclass
class Run:
    """What the metric readers read."""
    cell: "spec.Cell"
    setup_s: float
    window_s: float
    items: int                       # requests or steps completed
    tiles: int                       # their tiles
    call_s: list = field(default_factory=list)      # host time a call
    latency_s: list = field(default_factory=list)   # request latencies
    trace: "trace.Summary" = None

    @property
    def entry(self):
        return self.cell.entry


@dataclass
class Outcome:
    run: Run
    numbers: dict
    attempted: int
    failed: int
    memory_peak: int
    launches: dict
    phases: dict = field(default_factory=dict)   # set-up seconds by part


class _Phases(dict):
    """Seconds of each part of set-up, from the previous mark."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now


def _precision(config):
    p = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = p["cudnn_allow_tf32"]
    torch.backends.cudnn.benchmark = p["cudnn_benchmark"]


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device):
    if _on_card(device):
        torch.cuda.synchronize(device)


def _launches():
    from biscuit_torch.ops._build import launch_counts

    return launch_counts()


def _model(cell, seed, device):
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model

    hp = ModelParams.from_dict(cell.config["hp"])
    weights = make_weights(cell.config, seed, device)
    model = build_model(hp).to(device)
    model.load_state_dict(weights, strict=True)
    return hp, model, weights


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if _on_card(device) else 0


def _free(device):
    gc.collect()
    if _on_card(device):
        torch.cuda.empty_cache()


class _Window:
    """The measured window; with tracing, the kernel wrappers' spans and
    the profiler around it, and their summary after it."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.summary = None

    def __enter__(self):
        if self.tracing:
            self._wrap = trace.wrapped(spec.kernel_counts())
            self._bounds = self._wrap.__enter__()
            self._prof = trace.profiler()
            self._prof.start()
        self._span = trace.span("window")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self.tracing:
            self._prof.stop()
            self._wrap.__exit__(*exc)
            if exc[0] is None:
                self.summary = trace.summarize(self._prof, self._bounds)
            del self._prof
        return False


def _sane(mean, std, n, classes) -> bool:
    return (mean.shape == std.shape == (n, classes)
            and bool(np.isfinite(mean).all() and np.isfinite(std).all())
            and float(np.abs(mean.sum(axis=1) - 1).max()) <= 1e-3
            and float(std.min()) >= 0.0 and float(std.max()) <= 0.5)


def serve(cell, seed, seconds, tracing, device, t_proc) -> Outcome:
    from biscuit_torch.train.uq import UncertaintyInterface

    phases = _Phases()
    hp, model, weights = _model(cell, seed, device)
    model.eval()
    phases.mark("model")
    opts = cell.config.get("serving", {})
    iface = UncertaintyInterface.from_model(
        model, hp, device=device, use_kernel=opts.get("use_kernel"),
        fused_trunk=opts.get("fused_trunk"),
        fuse_blocks=opts.get("fuse_blocks", False))
    phases.mark("interface")
    tr = cell.traffic
    stream = Stream(tr, cell.config, seed, device)
    size, classes = stream.size, cell.config["classes"]
    phases.mark("traffic")

    def call(i):
        tiles = stream.slice(i)
        t0 = time.perf_counter()
        with trace.span("call"):
            mean, unc = iface(tiles, seed=stream.seed(i))
        t1 = time.perf_counter()
        with trace.span("readback"):
            out = mean.cpu().numpy(), unc.cpu().numpy()
        return out, t0, t1, time.perf_counter()

    warm = tr["warm_requests"]
    for i in range(warm):
        call(i)
    _sync(device)
    phases.mark("warm")
    before = _launches()
    outputs, latency, call_s = {}, [], []
    attempted = failed = done = 0
    with _Window(tracing) as win:
        t_start = time.perf_counter()
        t_end = t_start + seconds
        i = warm
        while time.perf_counter() < t_end:
            attempted += 1
            try:
                (mean, unc), t0, t1, t2 = call(i)
            except RuntimeError as e:          # the request is lost
                print(f"request {i} failed: {e}", file=sys.stderr)
                failed += 1
                i += 1
                continue
            latency.append(t2 - t0)
            call_s.append(t1 - t0)
            if _sane(mean, unc, size, classes):
                outputs[i] = (mean, unc)
                done += t2 <= t_end
            else:
                failed += 1
            i += 1
    launches = {k: v - before[k] for k, v in _launches().items()
                if v != before[k]}
    run = Run(cell, t_start - t_proc, seconds, done, done * size, call_s,
              latency, win.summary)
    peak = _peak(device)
    del iface, model
    _free(device)

    rng = np.random.default_rng(derive(seed, "check"))
    pool = sorted(outputs)
    sample = sorted(int(i) for i in rng.choice(
        pool, size=min(tr["check_requests"], len(pool)), replace=False)) \
        if pool else []
    with reference.exact():
        ref = [ref_serve.request(stream.slice(i), stream.seed(i), weights,
                                 cell.config, device)
               for i in sample]
    numbers = (check.serve_numbers([outputs[i] for i in sample], ref)
               if sample else {k: float("inf") for k in cell.limits})
    return Outcome(run, numbers, attempted, failed, peak, launches, phases)


def program_steps(cell, seed, device, checked, phases):
    """Set-up of a training cell: the step object built once and driven
    through its first ``checked`` steps by the window's own call and
    feed. Returns (call, readings of those steps, weights, stream,
    state)."""
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    hp, model, weights = _model(cell, seed, device)
    phases.mark("model")
    tx = make_optimizer(hp, model.parameters())
    step = make_train_step(model, tx, hp, make_normalizer(hp.normalizer),
                           device=device)
    phases.mark("step")
    stream = Stream(cell.traffic, cell.config, seed, device)
    phases.mark("traffic")

    def call(i):
        tiles, labels, mask = stream.batch(i)
        gen = torch.Generator(device=device).manual_seed(stream.seed(i))
        t0 = time.perf_counter()
        with trace.span("step"):
            out = step(tiles, labels, mask, gen)
        return out, time.perf_counter() - t0

    named = dict(model.named_parameters())
    state = tx.opt.state

    def moment(key, scale=1.0):
        return {n: float(state[p][key].norm()) * scale if p in state
                else 0.0 for n, p in named.items()}

    readings = {"loss": []}
    for i in range(checked):
        out, _ = call(i)
        readings["loss"].append(float(out["loss"]))
        if i == 0:      # the first gradient, by the published beta1
            readings["grad1"] = moment("exp_avg", 1 / (1 - ref_train.ADAM_B1))
    readings["adam_v"] = moment("exp_avg_sq")
    with torch.no_grad():
        readings["change"] = {n: float((p - weights[n]).norm())
                              for n, p in named.items()}
        readings["running"] = {
            n: float((b.float() - weights[n]).norm())
            for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}
    phases.mark("checked_steps")
    return call, readings, weights, stream, (model, tx, step)


def train(cell, seed, seconds, tracing, device, t_proc) -> Outcome:
    tr = cell.traffic
    checked = tr["checked_steps"]
    phases = _Phases()
    call, program, weights, stream, state = program_steps(
        cell, seed, device, checked, phases)
    _sync(device)
    before = _launches()
    losses, call_s = [], []
    with _Window(tracing) as win:
        t_start = time.perf_counter()
        t_end = t_start + seconds
        i = checked
        while time.perf_counter() < t_end:
            out, dt = call(i)
            losses.append(out.pop("loss"))
            call_s.append(dt)
            i += 1
        with trace.span("sync"):
            _sync(device)
        t_stop = time.perf_counter()
    launches = {k: v - before[k] for k, v in _launches().items()
                if v != before[k]}
    attempted = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses \
        else 0
    run = Run(cell, t_start - t_proc, t_stop - t_start, attempted,
              attempted * stream.size, call_s, [], win.summary)
    peak = _peak(device)
    del state, call, losses
    _free(device)

    with reference.exact():
        ref = ref_train.steps(weights, cell.config,
                              [(*stream.batch(i), stream.seed(i))
                               for i in range(checked)], device)
    for what, leaf, gap in check.worst_leaves(program, ref):
        print(f"worst leaf of {what}: {leaf} {gap!r}", file=sys.stderr)
    return Outcome(run, check.train_numbers(program, ref,
                                            cell.config["leaf_groups"]),
                   attempted, failed, peak, launches, phases)


DRIVERS = {"serve": serve, "train": train}


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(cell, seed: int, seconds: float, tracing: bool, device,
            t_proc: float):
    """One run of ``cell``: (the result line as a dict, 'checks' last;
    the record for standard error: the window's kernel launches, every
    number compared or read, the seconds of each part of set-up)."""
    _precision(cell.config)
    t_build = time.perf_counter()
    if _on_card(device):
        from biscuit_torch.ops._build import build_all

        build_all()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)       # the allocator, initialized
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter() - t_build
    out = DRIVERS[cell.entry](cell, seed, seconds, tracing, device, t_proc)
    ok, checks = check.judge(out.numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if tracing else cell.end_to_end):
        value = spec.reader(m["name"])(out.run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": out.memory_peak}
    line = {"correct": bool(ok and out.failed == 0 and out.attempted > 0),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": info}
    if tracing:
        s = out.run.trace
        info["busy_s"], info["window_s"] = s.busy_s, s.window_s
        if dev.type == "cuda":
            info["power_limit_w"] = power_limit()
        line["breakdown"] = {"device_ops": s.device_ops,
                             "idle_gaps": s.idle_gaps}
    line["checks"] = checks
    record = {"launches": out.launches, "readings": out.numbers,
              "setup_parts_s": {"before_kernels": out.run.setup_s - t_build
                                - sum(out.phases.values()),
                                "kernels": t_build, **out.phases}}
    return line, record
