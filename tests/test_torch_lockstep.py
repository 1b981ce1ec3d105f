"""Lockstep data parallelism of the port (biscuit_torch/parallel/lockstep.py
and its consumers) and the rest of its public surface, on the CPU.

N ranks on a global batch compute what one rank computes on it:

* ``TileBatcher(shard, num_shards)`` gives the JAX batcher's entries and
  batches, shard by shard.
* ``batch_norm_train`` and ``sep_bn_unit`` (plain and 'auto' backwards,
  which on the CPU both run the plain version) over two ranks on the
  halves of a batch against one rank on the whole: y, the statistics and
  the input gradient row by row, and the weight gradients summed over the
  ranks as the step sums them. A gamma or beta gradient that came out
  already global would be counted twice by that sum. Tolerance 1e-5 of
  each tensor's largest value: f32 sums in another order. The plain
  version of the kernel's second entry, fed the two halves' summed BN
  sums and the batch's pixel count, gives the whole batch's backward and
  leaves dgamma and dbeta to the sums; the second half's gy and p are
  shifted, so that a half's own sums would not do.
* A rank that raises after a collective aborts the group: the other one,
  waiting at a store barrier or for main's value, raises within seconds,
  and the call raises the first rank's error; a barrier that a rank never
  reaches raises at its timeout.
* ``make_train_step`` over ``Mesh(["cpu", "cpu"])`` (one thread a rank)
  against one rank on the global batch, module path and fused trunk, with
  'xyrjb' and dropout 0.3: the step-1 loss within 1e-6 relative and the
  step-2 loss within 1e-4 (Adam turns the gradients' f32 rounding into
  moves of about the learning rate; ROADMAP.md Queue 3), each gradient
  within 1e-4 of its largest value or, where the true gradient is ~0
  (a BatchNorm bias ahead of another BatchNorm), within 1e-6 of the
  tree's largest gradient, the running statistics within 1e-5; after two
  steps the ranks' weights are equal bit for bit.
* The same two-rank step, dropout 0 and no augmentation, against the JAX
  package's one-process ``make_train_step`` on the global batch from the
  same numpy weights, with tests/test_torch_trainer.py's f32 tolerances:
  one step, whose gradients no Adam update has touched yet.
* Two processes spawned from this file (``python
  tests/test_torch_lockstep.py RANK WORLD HOST:PORT ARGS``, gloo on the
  CPU, each killed at 60 s): ``global_batch``; ``ShardedServable`` over
  the spanning mesh, whose rows equal one process's call bit for bit, and
  which distributed scoring still refuses; one ``train_project`` fold over
  the spanning mesh, whose one model dir main wrote; its resume from an
  in-run checkpoint on both ranks; ``Experiment.run``'s step 2 in
  lockstep.
* The public surface: the package and subpackage names of the JAX
  package, no pandas on import; ``read_records``/``read_examples`` on a
  JAX-written file, and their CRC check; ``rgb_to_rgb``; ``available()``.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import time
from os.path import join

import numpy as np
import pytest
import torch

from biscuit_torch.data.pipeline import TileBatcher
from biscuit_torch.data.tfrecord import TFRecordWriter
from biscuit_torch.hp import ModelParams
from biscuit_torch.models.xception import batch_norm_train, build_model
from biscuit_torch.ops.fused_unit_bwd import (
    sep_bn_unit,
    unit_bwd_reference,
    unit_bwd_sums_reference,
)
from biscuit_torch.parallel import distributed as dist
from biscuit_torch.parallel.lockstep import (
    GroupAborted,
    choose_backend,
    run_ranks,
)
from biscuit_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD_TIMEOUT = 60
PX = 32
SERVE_BATCH = 4
TWO = Mesh(["cpu", "cpu"])


def _tiny_hp(**kw):
    base = dict(model="xception_tiny", tile_px=PX, tile_um=PX, batch_size=8,
                epochs=[1], early_stop=False, dropout=0.0, uq=False,
                hidden_layer_width=32, hidden_layers=2, learning_rate=3e-3,
                normalizer=None, augment="xy", uq_samples=4,
                compute_dtype="float32")
    base.update(kw)
    return ModelParams(**base)


def _tiles(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3),
                                                dtype=np.uint8)


# --- The child processes -------------------------------------------------

def _child(rank, world, addr, args_path):
    """One process of the two: each step's result into a JSON file."""
    from biscuit_torch import serve
    from biscuit_torch.experiment import Experiment
    from biscuit_torch.project import Project
    from biscuit_torch.utils_log import log

    torch.set_num_threads(1)
    resumed = []

    class Watch(logging.Handler):
        def emit(self, record):
            if "Resumed training" in record.getMessage():
                resumed.append(record.getMessage())

    log.addHandler(Watch())
    log.setLevel("INFO")
    with open(args_path) as f:
        args = json.load(f)
    dist.initialize(addr, world, rank, timeout_s=30)
    mesh = Mesh(["cpu"], spans_processes=True)
    out = {"rank": rank}
    gb = dist.global_batch({"image": np.full((3, 2), rank), "slide": "s"},
                           mesh)
    out["global_batch"] = [t.tolist() for t in gb["image"]]

    sh = serve.load_sharded_servable(args["artifact"], mesh=mesh)
    mean, std = sh.call_exact(torch.from_numpy(_tiles(2 * SERVE_BATCH, 3)),
                              seed=5)
    torch.save({"mean": mean, "std": std, "n_shards": sh.n_shards},
               f"{args['out']}_sharded_{rank}.pt")
    try:
        serve.predict_tfrecords_distributed(sh, [], args["out"] + "_wd")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)

    hp = _tiny_hp(epochs=[1], dropout=0.1)
    kw = dict(params=hp, val_k=[1], steps_per_epoch_override=2,
              checkpoint_every=1, save_model=True, mesh=mesh)
    project = Project(args["fold_root"])
    (model_dir,) = project.train("cohort", "LS", **kw)
    out["model_dir"] = model_dir
    out["resumed_first"] = list(resumed)
    # A relaunch after the run died past its first checkpoint.
    if dist.is_main():
        os.remove(join(model_dir, "results_log.csv"))
        import shutil

        shutil.rmtree(join(model_dir, "ckpt", "2"))
    dist.barrier("relaunch")
    (again,) = project.train("cohort", "LS", **kw)
    out["again"] = again
    out["resumed"] = resumed[len(out["resumed_first"]):]

    exp = Experiment(args["exp_root"], outcome="cohort", outcome1="LUAD",
                     outcome2="LUSC",
                     outdir=join(args["exp_root"], f"results{rank}"))
    exp.train_kwargs = {"device": "cpu", "seed": 0, "validate_on_batch": 2,
                        "steps_per_epoch_override": 2}
    exp.run({"ZC": {"out1": 6, "out2": 6}}, steps=[2], hp=_tiny_hp())
    with open(f"{args['out']}_{rank}.json", "w") as f:
        json.dump(out, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two processes' results, with the artifact and projects they
    used."""
    sys.path.insert(0, HERE)
    from test_torch_experiment import build_project

    from biscuit_torch import serve
    from biscuit_torch.train.trainer import init_model, save_checkpoint

    tmp = tmp_path_factory.mktemp("lockstep")
    hp = _tiny_hp(uq=True, dropout=0.2)
    model = init_model(build_model(hp), hp, torch.Generator().manual_seed(0))
    model_dir = save_checkpoint(str(tmp / "model"), model, hp, epoch=1,
                                outcome="cohort", label="LS", kfold=None)
    art = serve.export_servable(model_dir, str(tmp / "a.biscuit"),
                                batch_size=SERVE_BATCH, use_kernels=True,
                                device="cpu")
    fold_P = build_project(tmp, "fold", 6, seed=2)
    exp_P = build_project(tmp, "exp", 12, seed=5)
    args = {"artifact": art, "fold_root": fold_P.root,
            "exp_root": exp_P.root, "out": str(tmp / "child")}
    args_path = str(tmp / "args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", addr,
         args_path], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"child failed:\n{log[-3000:]}"
    results = []
    for r in range(2):
        with open(f"{args['out']}_{r}.json") as f:
            results.append(json.load(f))
    sharded = [torch.load(f"{args['out']}_sharded_{r}.pt")
               for r in range(2)]
    return results, sharded, art, fold_P, exp_P


# --- The sharded tile stream ----------------------------------------------

@pytest.fixture(scope="module")
def tfrecords(tmp_path_factory):
    from chip_smoke import encode_png

    root = tmp_path_factory.mktemp("shards")
    paths = []
    for i in range(3):
        p = str(root / f"sl{i}.tfrecords")
        with TFRecordWriter(p) as w:
            for t, tile in enumerate(_tiles(5 + i, 30 + i)):
                w.write_tile(f"sl{i}", encode_png(tile), loc_x=t, loc_y=i)
        paths.append(p)
    return paths


@pytest.mark.parametrize("num_shards", [2, 3])
def test_sharded_batcher_matches_jax(tfrecords, num_shards):
    from biscuit_tpu.data.pipeline import TileBatcher as JaxBatcher

    labels = {"sl0": 0, "sl1": 1, "sl2": 0}
    for shard in range(num_shards):
        kw = dict(batch_size=3, shuffle=True, infinite=False, seed=4,
                  max_tiles=6, tile_px=PX, shard=shard,
                  num_shards=num_shards)
        ours = TileBatcher(tfrecords, labels, **kw)
        theirs = JaxBatcher(tfrecords, labels, use_native=False, **kw)
        np.testing.assert_array_equal(ours.entries, theirs.entries)
        for a, b in zip(list(ours), list(theirs), strict=True):
            assert a["slide"] == b["slide"]
            for key in ("image", "label", "loc", "mask"):
                np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="shard"):
        TileBatcher(tfrecords, labels, shard=2, num_shards=2)


# --- BatchNorm and the fused unit over two ranks -----------------------------

def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _two_ranks(fn, *rows):
    """fn(group, *row_halves) on two CPU ranks -> both ranks' results."""
    out = {}

    def rank(group):
        n = rows[0].shape[0] // group.size
        out[group.rank] = fn(group, *(t[group.rank * n:][:n] for t in rows))

    run_ranks(TWO, rank)
    return out[0], out[1]


def test_batch_norm_train_over_two_ranks():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 5, 5, 8), generator=g) * 2 + 1
    gy = torch.randn((6, 5, 5, 8), generator=g)
    w0 = 1 + 0.1 * torch.randn(8, generator=g)
    b0 = 0.1 * torch.randn(8, generator=g)

    def run(group, x, gy):
        x = x.clone().requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        y, mu, var = batch_norm_train(x, w, b, 1e-5, (0, 1, 2), group)
        (y * gy).sum().backward()
        return y.detach(), mu, var, x.grad, w.grad, b.grad

    one = run(None, x, gy)
    r0, r1 = _two_ranks(run, x, gy)
    assert _rel(torch.cat([r0[0], r1[0]]), one[0]) <= 1e-5
    assert _rel(torch.cat([r0[3], r1[3]]), one[3]) <= 1e-5
    for i in (1, 2):
        assert torch.equal(r0[i], r1[i]) and _rel(r0[i], one[i]) <= 1e-5
    for i in (4, 5):
        # A rank's own share: summed as the step sums gradients.
        assert _rel(r0[i] + r1[i], one[i]) <= 1e-5
        assert _rel(r0[i], one[i]) > 1e-2


@pytest.mark.parametrize("backend", ["reference", "auto"])
@pytest.mark.parametrize("relu_first", [True, False])
def test_sep_bn_unit_over_two_ranks(backend, relu_first):
    g = torch.Generator().manual_seed(1)
    a = torch.randn((4, 6, 6, 8), generator=g)
    gy = torch.randn((4, 6, 6, 16), generator=g)
    weights = (0.3 * torch.randn((9, 8), generator=g),
               torch.randn((8, 16), generator=g) / 8 ** 0.5,
               1 + 0.1 * torch.randn(16, generator=g),
               0.1 * torch.randn(16, generator=g))

    def run(group, a, gy):
        a = a.clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in weights]
        y, mu, var = sep_bn_unit(a, *ws, 1e-5, relu_first, backend, group)
        (y * gy).sum().backward()
        return (y.detach(), mu, var, a.grad, *(w.grad for w in ws))

    one = run(None, a, gy)
    r0, r1 = _two_ranks(run, a, gy)
    assert _rel(torch.cat([r0[0], r1[0]]), one[0]) <= 1e-5
    assert _rel(torch.cat([r0[3], r1[3]]), one[3]) <= 1e-5     # da
    for i in (1, 2):
        assert torch.equal(r0[i], r1[i]) and _rel(r0[i], one[i]) <= 1e-5
    for i in (4, 5, 6, 7):                # dWdw, dWpw, dgamma, dbeta
        assert _rel(r0[i] + r1[i], one[i]) <= 1e-5, i
    assert _rel(r0[6], one[6]) > 1e-2 and _rel(r0[7], one[7]) > 1e-2


@pytest.mark.parametrize("relu_first", [True, False])
def test_unit_bwd_reference_from_two_halves_sums(relu_first):
    g = torch.Generator().manual_seed(2)
    r, d = (torch.randn((4, 5, 5, 8), generator=g) for _ in range(2))
    gy, p = (torch.randn((4, 5, 5, 16), generator=g) for _ in range(2))
    gy[2:] += 1      # each half's own sums far from the batch's
    p[2:] += 1
    taps = 0.3 * torch.randn((9, 8), generator=g)
    wpw = torch.randn((8, 16), generator=g) / 8 ** 0.5
    gamma = 1 + 0.1 * torch.randn(16, generator=g)
    mu, var = p.mean(dim=(0, 1, 2)), p.var(dim=(0, 1, 2), unbiased=False)
    rest = (taps, wpw, gamma, mu, var, 1e-5, relu_first)
    one = unit_bwd_reference(gy, r, d, p, *rest)
    halves = [[t[i * 2:(i + 1) * 2] for t in (gy, r, d, p)] for i in (0, 1)]
    sums = sum(unit_bwd_sums_reference(h[0], h[3], mu, var, 1e-5)
               for h in halves)
    outs = [unit_bwd_reference(*h, *rest, sums=sums, m=gy[..., 0].numel())
            for h in halves]
    assert all(o[3] is None and o[4] is None for o in outs)
    assert _rel(torch.cat([outs[0][0], outs[1][0]]), one[0]) <= 1e-5
    for i in (1, 2):
        assert _rel(outs[0][i] + outs[1][i], one[i]) <= 1e-5, i
    assert _rel(sums[1], one[3]) <= 1e-5 and _rel(sums[0], one[4]) <= 1e-5


@pytest.mark.parametrize("wait,failing", [("barrier", 0), ("barrier", 1),
                                          ("broadcast", 0)])
def test_an_error_after_a_collective_aborts_the_waiting_rank(wait, failing):
    seen = {}

    def fn(group):
        group.all_reduce_sum([torch.ones(3)])
        if group.rank == failing:
            raise KeyError(f"rank {failing} failed")
        try:
            if wait == "barrier":
                group.barrier("never")
            else:
                group.broadcast_from_main("never", None)
        except GroupAborted as e:
            seen[group.rank] = str(e)
            raise

    t0 = time.monotonic()
    with pytest.raises(KeyError, match=f"rank {failing} failed"):
        run_ranks(TWO, fn)
    assert time.monotonic() - t0 < 30
    assert seen == {1 - failing: f"rank {failing} raised KeyError: "
                                 f"'rank {failing} failed'"}


def test_a_barrier_that_a_rank_never_reaches_times_out():
    def fn(group):
        if group.rank == 0:
            group.barrier("alone", timeout_ms=300)

    with pytest.raises(TimeoutError, match="alone"):
        run_ranks(TWO, fn)


def test_backend_rule():
    assert choose_backend(["cpu", "cpu"]) == "gloo"
    assert choose_backend(["cuda|h|a", "cuda|h|a"]) == "gloo"
    assert choose_backend(["cuda|h|a", "cpu"]) == "gloo"
    assert choose_backend(["cuda|h|a", "cuda|h|b"]) == "nccl"
    assert run_ranks(TWO, lambda group: group.backend) == "gloo"


def test_a_mesh_that_repeats_a_card_is_refused():
    with pytest.raises(ValueError, match="repeats a card"):
        run_ranks(Mesh(["cuda:0", "cuda:0"]), lambda group: None)
    with pytest.raises(ValueError, match="no multi-process runtime"):
        run_ranks(Mesh(["cpu"], spans_processes=True), lambda group: None)


def test_an_error_on_one_rank_is_raised():
    def fn(group):
        if group.rank == 1:
            raise KeyError("rank 1")
        return group.rank

    with pytest.raises(KeyError, match="rank 1"):
        run_ranks(TWO, fn)


# --- The train step ------------------------------------------------------

N = 8


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (N, PX, PX, 3), dtype=np.uint8),
            np.array([0, 1, 1, 0, 1, 0, 0, -1], np.int32),
            np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32))


def _steps(hp, fused, group=None, state=None, steps=2):
    """``steps`` train steps (one rank, or this rank's rows); returns the
    losses, step 1's gradients, the state after step 1 and after all."""
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.train import trainer as ttr

    model = build_model(hp)
    if state is None:
        ttr.init_model(model, hp, torch.Generator().manual_seed(3))
    else:
        model.load_state_dict(state)
    tx = ttr.make_optimizer(hp, model.parameters())
    step = ttr.make_train_step(model, tx, hp, make_normalizer(hp.normalizer),
                               fused_trunk=fused, device="cpu", group=group)
    gen = torch.Generator().manual_seed(5)
    rows = slice(0, N) if group is None else slice(
        group.rank * N // group.size, (group.rank + 1) * N // group.size)
    losses = []
    for i in range(steps):
        out = step(*(torch.from_numpy(t[rows]) for t in _batch()), gen)
        losses.append((float(out["loss"]), float(out["acc"])))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            first = {k: v.clone() for k, v in model.state_dict().items()}
    return losses, grads, first, model.state_dict()


def _close_grads(got, want, rtol, floor):
    tree = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        diff = (got[k] - w).abs().max().item()
        assert diff <= rtol * w.abs().max().item() or diff <= floor * tree, k


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_over_two_ranks_is_one_rank_on_the_batch(fused):
    hp = _tiny_hp(dropout=0.3, augment="xyrjb", batch_size=N)
    losses, grads, first, _ = _steps(hp, fused)
    ranks = {}

    def rank(group):
        ranks[group.rank] = _steps(hp, fused, group)

    run_ranks(TWO, rank)
    (l0, g0, f0, s0), (l1, _, _, s1) = ranks[0], ranks[1]
    assert l0 == l1
    for (got, acc), (want, want_acc), rtol in zip(l0, losses, (1e-6, 1e-4)):
        assert abs(got - want) <= rtol * abs(want) and acc == want_acc
    _close_grads(g0, grads, 1e-4, 1e-6)
    for k, v in first.items():
        if "running" in k:
            assert _rel(f0[k], v) <= 1e-5, k
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_over_two_ranks_matches_jax(fused):
    """Against the JAX module path's step (flax autodiff, f32): the fused
    trunk's f32 backward is the same arithmetic in f32."""
    sys.path.insert(0, HERE)
    from test_torch_trainer import _flat, _hp, _jax_step, _state

    from biscuit_torch.models.convert import from_flax, to_flax

    params, stats, images, labels, mask = _state()
    loss_j, acc_j, grads_j, bs_j = _jax_step("float32", False)
    hp = ModelParams(**_hp("float32").to_dict())
    out = {}

    def rank(group):
        from biscuit_torch.data.normalize import make_normalizer
        from biscuit_torch.train import trainer as ttr

        model = build_model(hp)
        model.load_state_dict(from_flax(params, stats))
        step = ttr.make_train_step(
            model, ttr.make_optimizer(hp, model.parameters()), hp,
            make_normalizer(hp.normalizer), fused_trunk=fused, device="cpu",
            group=group)
        n = images.shape[0] // group.size
        rows = slice(group.rank * n, (group.rank + 1) * n)
        res = step(*(torch.from_numpy(t[rows]) for t in (images, labels,
                                                         mask)),
                   torch.Generator().manual_seed(1))
        grads = to_flax({k: p.grad for k, p in model.named_parameters()})[0]
        out[group.rank] = (float(res["loss"]), float(res["acc"]),
                           dict(_flat(grads)),
                           dict(_flat(to_flax(model.state_dict())[1])))

    run_ranks(TWO, rank)
    loss, acc, grads, bs = out[0]
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j) and acc == acc_j
    tree = max(np.abs(v).max() for v in grads_j.values())
    for key, w in grads_j.items():
        diff = np.abs(grads[key] - w).max()
        assert diff < 1e-3 * np.abs(w).max() or diff < 1e-4 * tree, key
    for key, w in bs_j.items():
        assert np.abs(bs[key] - w).max() <= 1e-4 * np.abs(w).max(), key


def test_val_metrics_are_the_groups():
    from biscuit_torch.train.trainer import make_val_metrics_step

    hp = _tiny_hp()
    images, labels, mask = _batch()
    model = build_model(hp)
    want = make_val_metrics_step(model, None)(images, labels, mask)
    got = {}

    def rank(group):
        n = N // group.size
        rows = slice(group.rank * n, (group.rank + 1) * n)
        got[group.rank] = make_val_metrics_step(model, None, group)(
            images[rows], labels[rows], mask[rows])

    run_ranks(TWO, rank)
    for r in range(2):
        assert [float(v) for v in got[r]] == [float(v) for v in want]


def test_train_project_over_two_cpu_ranks(tmp_path):
    sys.path.insert(0, HERE)
    from test_torch_experiment import build_project

    P = build_project(tmp_path, "p", 6, seed=1)
    (model_dir,) = P.train("cohort", "LS", params=_tiny_hp(batch_size=8),
                           val_k=[1], steps_per_epoch_override=2, mesh=TWO,
                           save_model=True)
    assert os.listdir(P.models_dir) == [os.path.basename(model_dir)]
    files = set(os.listdir(model_dir))
    assert {"slide_manifest.csv", "params.json", "results_log.csv",
            "train_log.csv", "tile_predictions_val_epoch1.csv",
            "cohort-LS-HP0-kfold1_epoch1"} <= files
    with pytest.raises(ValueError, match="does not divide"):
        P.train("cohort", "LS", params=_tiny_hp(batch_size=7), val_k=[1],
                mesh=TWO)


# --- Two processes ---------------------------------------------------------

def test_global_batch_over_processes(group):
    results = group[0]
    for r, res in enumerate(results):
        assert res["global_batch"] == [[[r, r]] * 3]


def test_global_batch_in_one_process():
    b = dist.global_batch({"image": np.arange(12).reshape(6, 2),
                           "slide": ["a"] * 6}, TWO)
    assert [t.tolist() for t in b["image"]] == [
        np.arange(6).reshape(3, 2).tolist(),
        np.arange(6, 12).reshape(3, 2).tolist()]
    assert b["slide"] == ["a"] * 6
    with pytest.raises(ValueError, match="leading sizes"):
        dist.global_batch({"a": np.zeros(4), "b": np.zeros(6)}, TWO)


def test_sharded_servable_over_processes_is_one_processs_call(group):
    from biscuit_torch import serve

    _, sharded, art, _, _ = group
    sh = serve.load_sharded_servable(art, mesh=TWO)
    want = sh.call_exact(torch.from_numpy(_tiles(2 * SERVE_BATCH, 3)),
                         seed=5)
    for got in sharded:
        assert got["n_shards"] == 2
        assert torch.equal(got["mean"], want[0])
        assert torch.equal(got["std"], want[1])
    for res in group[0]:
        assert "this process's devices only" in res["refused"]


def test_train_project_over_processes_writes_one_model_dir(group):
    results, _, _, fold_P, _ = group
    dirs = os.listdir(fold_P.models_dir)
    assert len(dirs) == 1
    model_dir = join(fold_P.models_dir, dirs[0])
    assert all(r["model_dir"] == model_dir == r["again"] for r in results)
    files = set(os.listdir(model_dir))
    assert {"slide_manifest.csv", "params.json", "results_log.csv",
            "train_log.csv", "tile_predictions_val_epoch1.csv",
            "patient_predictions_cohort_val_epoch1.csv",
            "slide_predictions_cohort_val_epoch1.csv",
            "cohort-LS-HP0-kfold1_epoch1", "ckpt"} <= files
    assert sorted(os.listdir(join(model_dir, "ckpt"))) == ["1", "2"]


def test_every_rank_resumes_from_mains_checkpoint(group):
    for res in group[0]:
        assert res["resumed_first"] == []
        assert res["resumed"] == ["Resumed training from checkpoint step 1"]


def test_experiment_step_in_lockstep_over_processes(group):
    exp_P = group[4]
    dirs = sorted(os.listdir(exp_P.models_dir))
    assert sorted(d[6:] for d in dirs) == [
        f"cohort-EXP_ZC-HP0-kfold{k}" for k in (1, 2, 3)]
    for d in dirs:
        assert os.path.exists(join(exp_P.models_dir, d, "results_log.csv"))
    assert os.path.exists(join(exp_P.root, "experiments.csv"))


# --- The rest of the public surface ------------------------------------------

def _public_names(init_path):
    """The names a package's ``__init__`` exports: what it imports, and
    the string names its ``_LAZY`` table or ``__getattr__`` serves."""
    import ast

    names = set()
    tree = ast.parse(open(init_path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "_LAZY" for t in node.targets):
            names |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.value for c in ast.walk(node)
                      if isinstance(c, ast.Constant)
                      and isinstance(c.value, str) and c.value.isidentifier()}
    return names - {"__name__"}


def test_public_names_match_jax():
    import importlib

    for sub in ("", ".models", ".stats", ".train", ".data"):
        path = sub.replace(".", "/")
        want = _public_names(join(REPO, f"biscuit_tpu{path}", "__init__.py"))
        got = _public_names(join(REPO, f"biscuit_torch{path}",
                                 "__init__.py"))
        assert want <= got, (sub, sorted(want - got))
        mod = importlib.import_module(f"biscuit_torch{sub}")
        for name in want:
            assert getattr(mod, name) is not None, (sub, name)
    import biscuit_torch

    assert biscuit_torch.Experiment.__name__ == "Experiment"
    assert biscuit_torch.Heatmap.__name__ == "Heatmap"
    assert callable(biscuit_torch.find_cv)


def test_importing_the_package_imports_no_pandas():
    code = ("import sys, biscuit_torch, biscuit_torch.models, "
            "biscuit_torch.stats, biscuit_torch.train, biscuit_torch.data; "
            "print('pandas' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout.split()
    assert out == ["False", "False"]


def test_sequential_readers_match_jax(tmp_path):
    from biscuit_tpu.data import tfrecord as jtf

    from biscuit_torch.data import tfrecord as ttf

    path = str(tmp_path / "j.tfrecords")
    with jtf.TFRecordWriter(path) as w:
        for t in range(4):
            w.write_tile("s", bytes([t]) * (10 + t), loc_x=t, loc_y=2 * t)
    for verify in (False, True):
        assert list(ttf.read_records(path, verify)) == list(
            jtf.read_records(path, verify))
        assert list(ttf.read_examples(path, verify)) == list(
            jtf.read_examples(path, verify))
    raw = bytearray(open(path, "rb").read())
    for at, what in ((9, "header"), (20, "payload")):
        bad = tmp_path / f"bad_{what}.tfrecords"
        flipped = bytearray(raw)
        flipped[at] ^= 0x40
        bad.write_bytes(bytes(flipped))
        for mod in (ttf, jtf):
            with pytest.raises(IOError, match=what):
                list(mod.read_examples(str(bad), verify=True))


def test_rgb_to_rgb_is_the_normalizer():
    from biscuit_torch.data.normalize import (
        ReinhardFastNormalizer,
        ReinhardNormalizer,
    )

    x = torch.from_numpy(_tiles(2, 1)).float()
    for cls in (ReinhardFastNormalizer, ReinhardNormalizer):
        norm = cls()
        assert torch.equal(norm.rgb_to_rgb(x), norm(x))
        assert torch.equal(norm.rgb_to_rgb(x[0]), norm(x[0]))


def test_native_loader_available(monkeypatch):
    from biscuit_torch.data import native_loader

    assert native_loader.available() is True
    for err in (OSError("no library"), RuntimeError("g++ failed")):
        def fail(err=err):
            raise err
        monkeypatch.setattr(native_loader, "load", fail)
        assert native_loader.available() is False


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
