"""The port's parallelism that needs no collective (biscuit_torch/parallel/
and its consumers) on the CPU.

* The single-process primitives and ``partition_submeshes`` against the
  JAX package's (biscuit_tpu/parallel/).
* Two processes, spawned from this file (``python
  tests/test_torch_parallel.py MODE RANK WORLD HOST:PORT ARGS``), joined
  through a ``TCPStore`` on a free localhost port: claims, exchanges,
  broadcast and barrier; ``predict_tfrecords_distributed`` merged equal
  bit for bit to the single-process call with the same seed (each
  tfrecord is scored with its own seed, whichever process claims it), and
  to ``predict_tfrecords`` at dropout 0 within 1e-6 (other batch
  compositions); ``evaluate_project`` with main evaluating; fold
  scheduling across the processes, each fold trained once; a failing
  peer aborting both. Every child is bounded by a 60-s timeout and killed
  when it expires.
* ``Experiment.run`` with ``n_submeshes=2`` over two CPU threads against
  the sequential run, as tests/test_submesh_experiment.py holds the JAX
  package: the same model set, results logs and predictions (equal: the
  trainings are the same arithmetic on the same device).
* ``ShardedServable`` over two CPU devices against ``Servable``: each
  shard equals ``Servable`` at the shard's seed, bit for bit.
* A mesh of several devices trains in lockstep; a mesh that spans
  processes, without a multi-process runtime, is refused.
"""

import json
import os
import socket
import subprocess
import sys
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch

from biscuit_torch import serve
from biscuit_torch.parallel import distributed as dist
from biscuit_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    data_parallel_mesh,
    replicated,
    shard_batch,
)
from biscuit_torch.parallel.scheduler import (
    SubmeshScheduler,
    partition_submeshes,
)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD_TIMEOUT = 60
PX = 32
BATCH = 8
SEED = 7
N_TOKENS = 24


# --- The child processes -------------------------------------------------

def _child(mode, rank, world, addr, args_path):
    """One process of a two-process group; writes its results as JSON."""
    torch.set_num_threads(1)
    with open(args_path) as f:
        args = json.load(f)
    dist.initialize(addr, world, rank, timeout_s=30)
    out = {"rank": rank}
    if mode == "suite":
        won = [t for t in range(N_TOKENS) if dist.try_claim(f"tok{t}")]
        out["won"] = won
        out["ok_all"] = dist.exchange_ok("all", True)
        out["ok_mixed"] = dist.exchange_ok("mixed", rank == 0)
        out["values"] = dist.exchange_values("vals", f"r{rank}")
        out["broadcast"] = dist.broadcast_from_main(
            "hello", "from-main" if dist.is_main() else None)
        dist.barrier("primitives")
        out["shards_before"] = len(os.listdir(args["workdir"]))
        sv = serve.load_servable(args["artifact"], device="cpu")
        df = serve.predict_tfrecords_distributed(
            sv, args["tfrecords"], args["workdir"], seed=SEED)
        df.to_pickle(f"{args['out']}_{rank}.pkl")
        from biscuit_torch.project import Project

        res = Project(args["eval_root"]).evaluate(
            args["model_dir"], "cohort", device="cpu")
        out["eval"] = {k: list(v) if isinstance(v, tuple) else v
                       for k, v in res.items()}
        from biscuit_torch.experiment import Experiment

        exp = Experiment(args["train_root"], outcome="cohort",
                         outcome1="LUAD", outcome2="LUSC",
                         outdir=join(args["train_root"], f"results{rank}"))
        exp.train_kwargs = {"device": "cpu", "seed": 0, "n_submeshes": 1,
                            "validate_on_batch": 2,
                            "steps_per_epoch_override": 2}
        exp.run({"ZC": {"out1": 6, "out2": 6}}, steps=[2], hp=_tiny_hp())
    elif mode == "predictfail":
        if rank == 1:
            def fail(name):
                raise RuntimeError("injected scoring failure")
            dist.try_claim = fail
        sv = serve.load_servable(args["artifact"], device="cpu")
        try:
            serve.predict_tfrecords_distributed(sv, args["tfrecords"],
                                                args["workdir"], seed=SEED)
            out["error"] = None
        except Exception as e:
            out["error"] = str(e)
    with open(f"{args['out']}_{rank}.json", "w") as f:
        json.dump(out, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(mode, args, tmp_path, world=2):
    """Run ``world`` children; each is killed at CHILD_TIMEOUT. Returns
    their JSON results in rank order."""
    args_path = str(tmp_path / f"{mode}_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         addr, args_path], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    for r in range(world):
        with open(f"{args['out']}_{r}.json") as f:
            results.append(json.load(f))
    return results


# --- Fixtures -------------------------------------------------------------

def _tiny_hp(**kw):
    from biscuit_torch.hp import ModelParams

    base = dict(model="xception_tiny", tile_px=PX, tile_um=PX, batch_size=16,
                epochs=[1], early_stop=False, dropout=0.0, uq=False,
                hidden_layer_width=32, hidden_layers=2, learning_rate=3e-3,
                normalizer=None, augment="xy", uq_samples=4)
    base.update(kw)
    return ModelParams(**base)


def _tiles(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def scoring(tmp_path_factory):
    """A dropout-0 model dir, its artifact at batch BATCH (the op graph,
    whose ops run their plain versions on the CPU), and six tfrecords of
    5 PNG tiles (the last one empty)."""
    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import init_model, save_checkpoint
    from chip_smoke import encode_png

    root = tmp_path_factory.mktemp("parallel")
    hp = _tiny_hp(uq=True)
    model = init_model(build_model(hp), hp, torch.Generator().manual_seed(0))
    model_dir = save_checkpoint(str(root / "model"), model, hp, epoch=1,
                                outcome="cohort", label="PAR", kfold=None)
    art = serve.export_servable(model_dir, str(root / "a.biscuit"),
                                batch_size=BATCH, use_kernels=True,
                                device="cpu", with_features=True)
    tfr = root / "tfr"
    tfr.mkdir()
    paths = []
    for i in range(6):
        p = str(tfr / f"sl{i}.tfrecords")
        with TFRecordWriter(p) as w:
            for t, tile in enumerate(_tiles(5 if i < 5 else 0, 20 + i)):
                w.write_tile(f"sl{i}", encode_png(tile), loc_x=t, loc_y=i)
        paths.append(p)
    return root, model_dir, art, paths


@pytest.fixture(scope="module")
def group(scoring, tmp_path_factory):
    """The two-process suite's results, the single-process scoring call
    and a fresh (empty) copy of the projects it trained and evaluated."""
    sys.path.insert(0, HERE)
    from test_torch_experiment import build_project

    root, model_dir, art, paths = scoring
    tmp = tmp_path_factory.mktemp("group")
    workdir = str(tmp / "scored")
    os.makedirs(workdir)
    sv = serve.load_servable(art, device="cpu")
    single = serve.predict_tfrecords_distributed(sv, paths, workdir,
                                                 seed=SEED)
    eval_P = build_project(tmp, "ev", 6, seed=4)
    train_P = build_project(tmp, "tr", 12, seed=5)
    args = {"artifact": art, "tfrecords": paths, "workdir": workdir,
            "model_dir": model_dir, "eval_root": eval_P.root,
            "train_root": train_P.root, "out": str(tmp / "suite")}
    results = _run_group("suite", args, tmp)
    frames = [pd.read_pickle(f"{args['out']}_{r}.pkl") for r in range(2)]
    return results, frames, single, sv, eval_P, train_P


# --- Single process --------------------------------------------------------

def test_single_process_primitives_match_jax(monkeypatch):
    from biscuit_tpu.parallel import distributed as jdist

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize()                      # no torchrun variables: no-op
    assert dist.process_count() == 1
    for mod in (dist, jdist):
        assert mod.process_shard() == (0, 1) and mod.is_main()
        assert mod.barrier("b") is None
        assert mod.broadcast_from_main("x", "v") == "v"
        assert mod.try_claim("t") is True and mod.try_claim("t") is True
        assert mod.exchange_ok("o", False) is False
        assert mod.exchange_ok("o", True) is True
        assert mod.exchange_values("v", "7") == ["7"]
    assert not dist.mesh_spans_processes(Mesh(["cpu", "cpu"]))
    assert dist.mesh_spans_processes(Mesh(["cpu"], spans_processes=True))


def test_initialize_without_a_store_raises():
    with pytest.raises(ValueError, match="together"):
        dist.initialize("127.0.0.1:1", 2)
    with pytest.raises(Exception):
        dist.initialize(f"127.0.0.1:{_free_port()}", 2, 1, timeout_s=1)
    assert dist.process_count() == 1


@pytest.mark.parametrize("n_dev,n_sub", [(8, 1), (8, 2), (8, 3), (5, 2),
                                         (4, 4)])
def test_partition_submeshes_matches_jax(n_dev, n_sub):
    import jax

    from biscuit_tpu.parallel.scheduler import partition_submeshes as jpart

    want = [[d.id for d in m.devices.flat]
            for m in jpart(n_sub, jax.devices()[:n_dev])]
    got = [[d.index for d in m.devices] for m in partition_submeshes(
        n_sub, [torch.device("cuda", i) for i in range(n_dev)])]
    assert got == want
    with pytest.raises(ValueError, match="Cannot build"):
        jpart(n_dev + 1, jax.devices()[:n_dev])
    with pytest.raises(ValueError, match="Cannot build"):
        partition_submeshes(n_dev + 1, ["cpu"] * n_dev)


def test_mesh_shardings():
    mesh = data_parallel_mesh(["cpu", "cpu"])
    assert mesh.shape == {"data": 2} and mesh.size == 2
    x = np.arange(12).reshape(6, 2)
    parts = batch_sharding(mesh).place(x)
    assert [p.tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    assert all(torch.equal(p, torch.from_numpy(x))
               for p in replicated(mesh).place(x))
    b = shard_batch({"image": x, "slide": ["a"] * 6}, mesh)
    assert len(b["image"]) == 2 and b["slide"] == ["a"] * 6
    with pytest.raises(ValueError, match="evenly"):
        batch_sharding(mesh).place(np.zeros(5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            data_parallel_mesh()


def test_scheduler_runs_tasks_in_order_and_collects_errors():
    sched = SubmeshScheduler(n_submeshes=2, devices=["cpu", "cpu"])
    assert [m.size for m in sched.meshes] == [1, 1]

    def task(i):
        def run(mesh):
            if i == 3:
                raise RuntimeError("task 3")
            return (i, str(mesh.devices[0]))
        return run

    res = sched.run([task(i) for i in range(5)])
    assert [r[0] for r in res if not isinstance(r, Exception)] == [0, 1, 2, 4]
    assert isinstance(res[3], RuntimeError)


def test_scheduler_refuses_global_devices_under_multiprocess(monkeypatch):
    monkeypatch.setitem(dist._state, "world", 2)
    with pytest.raises(ValueError, match="multi-process"):
        SubmeshScheduler(n_submeshes=1)
    assert len(SubmeshScheduler(1, devices=["cpu"]).meshes) == 1


# --- Two processes ---------------------------------------------------------

def test_every_claim_is_won_once(group):
    results = group[0]
    won = [set(r["won"]) for r in results]
    assert won[0].isdisjoint(won[1])
    assert won[0] | won[1] == set(range(N_TOKENS))


def test_exchanges_broadcast_and_barrier(group):
    for r in group[0]:
        assert r["ok_all"] is True and r["ok_mixed"] is False
        assert r["values"] == ["r0", "r1"]
        assert r["broadcast"] == "from-main"


def test_distributed_scoring_merges_to_single_process(group, scoring):
    results, frames, single, sv, *_ = group
    paths = scoring[3]
    pd.testing.assert_frame_equal(frames[0], frames[1])
    pd.testing.assert_frame_equal(frames[0], single)
    assert len(single) == 25 and single.slide.tolist() == sorted(
        single.slide.tolist())
    # The single-process call's shard was in the workdir when the group
    # ran; the per-call nonce kept it out of the group's merge.
    assert any(r["shards_before"] > 0 for r in results)
    # Each tfrecord scored alone with its own seed, bit for bit.
    want = pd.concat([serve.predict_tfrecords(
        sv, [p], seed=serve._fold_seed(SEED, i))
        for i, p in enumerate(paths[:5])], ignore_index=True)
    pd.testing.assert_frame_equal(single, want)
    # And the whole list in one call, at dropout 0.
    plain = serve.predict_tfrecords(sv, paths[:5], seed=SEED)
    pd.testing.assert_frame_equal(single, plain, check_exact=False,
                                  rtol=0, atol=1e-6)


def test_evaluate_main_evaluates_and_publishes(group):
    results, *_, eval_P, _ = group
    evals = [r["eval"] for r in results]
    assert evals[0] == evals[1]
    dirs = os.listdir(eval_P.eval_dir)
    assert len(dirs) == 1 and evals[0]["eval_dir"].endswith(dirs[0])
    for name in ("results_log.csv", "tile_predictions_eval.csv"):
        assert os.path.exists(join(eval_P.eval_dir, dirs[0], name))


def test_fold_scheduling_across_processes_trains_each_fold_once(group):
    train_P = group[-1]
    dirs = sorted(os.listdir(train_P.models_dir))
    assert sorted(d[6:] for d in dirs) == [
        f"cohort-EXP_ZC-HP0-kfold{k}" for k in (1, 2, 3)]
    for d in dirs:
        assert os.path.exists(join(train_P.models_dir, d, "results_log.csv"))
    assert os.path.exists(join(train_P.root, "experiments.csv"))


def test_a_failing_peer_aborts_every_process(scoring, tmp_path):
    _, _, art, paths = scoring
    args = {"artifact": art, "tfrecords": paths,
            "workdir": str(tmp_path / "scored"), "out": str(tmp_path / "f")}
    errs = [r["error"] for r in _run_group("predictfail", args, tmp_path)]
    assert errs[1] == "injected scoring failure"
    assert "peer process failed distributed scoring" in errs[0]


# --- Submeshes in one process ---------------------------------------------

def _model_map(P):
    """{dir suffix: path}: the run number depends on the order of
    allocation, which threads change."""
    return {d[6:]: join(P.models_dir, d) for d in os.listdir(P.models_dir)}


@pytest.fixture(scope="module")
def submesh_runs(tmp_path_factory):
    sys.path.insert(0, HERE)
    from test_torch_experiment import build_project

    from biscuit_torch.experiment import Experiment

    tmp = tmp_path_factory.mktemp("submesh")
    runs = []
    for name, extra in (("seq", {}), ("par", {"n_submeshes": 2})):
        (tmp / name).mkdir()
        P = build_project(tmp / name, "p", 16, seed=0)
        exp = Experiment(P, outcome="cohort", outcome1="LUAD",
                         outcome2="LUSC", outdir=str(tmp / f"{name}_res"))
        exp.train_kwargs = {"device": "cpu", "seed": 0,
                            "validate_on_batch": 2,
                            "steps_per_epoch_override": 2, **extra}
        exp.run({"ZC": {"out1": 6, "out2": 6}}, steps=[2, 3],
                hp=_tiny_hp(dropout=0.1))
        runs.append(P)
    return runs


def test_submeshes_train_the_same_models(submesh_runs):
    seq, par = (_model_map(P) for P in submesh_runs)
    assert set(seq) == set(par) and len(seq) == 6    # 3 CV + 3 UQ folds
    for suffix, sdir in seq.items():
        for name in ("results_log.csv", "tile_predictions_val_epoch1.csv"):
            s = pd.read_csv(join(sdir, name))
            p = pd.read_csv(join(par[suffix], name))
            pd.testing.assert_frame_equal(s, p)


def test_sharded_servable_equals_servable_per_shard(scoring):
    art = scoring[2]
    sv = serve.load_servable(art, device="cpu")
    sh = serve.load_sharded_servable(art, mesh=data_parallel_mesh(
        ["cpu", "cpu"]))
    assert (sh.n_shards, sh.global_batch) == (2, 2 * BATCH)
    tiles = _tiles(2 * BATCH, 3)
    got = sh.call_exact(tiles, seed=5)
    for i in range(2):
        want = sv.call_exact(tiles[i * BATCH:(i + 1) * BATCH],
                             seed=serve._fold_seed(5, i))
        for g, w in zip(got, want):
            assert torch.equal(g[i * BATCH:(i + 1) * BATCH], w)
    feats, mean, _ = sh.features(tiles[:11], seed=5)
    assert feats.shape[0] == mean.shape[0] == 11
    with pytest.raises(ValueError, match="shape"):
        sh.call_exact(tiles[:BATCH])


# --- The meshes of lockstep data parallelism ------------------------------

def test_train_project_over_a_multi_device_mesh_trains_in_lockstep(group):
    """A mesh of two CPU devices trains one model in lockstep (one rank a
    device, tests/test_torch_lockstep.py holds it against one rank); a
    mesh that spans processes needs a multi-process runtime."""
    from biscuit_torch.train.trainer import train_project

    train_P = group[-1]
    before = set(os.listdir(train_P.models_dir))
    (model_dir,) = train_project(
        train_P, "cohort", "LOCK", params=_tiny_hp(batch_size=8),
        val_k=[1], steps_per_epoch_override=1, mesh=Mesh(["cpu", "cpu"]))
    assert set(os.listdir(train_P.models_dir)) - before == {
        os.path.basename(model_dir)}
    assert os.path.exists(join(model_dir, "results_log.csv"))
    with pytest.raises(ValueError, match="no multi-process runtime"):
        train_project(train_P, "cohort", "X", params=_tiny_hp(),
                      mesh=Mesh(["cpu"], spans_processes=True))


def test_global_batch_places_a_processs_rows_on_its_mesh():
    b = dist.global_batch({"image": np.arange(8).reshape(4, 2),
                           "slide": ["s"] * 4}, Mesh(["cpu", "cpu"]))
    assert [p.tolist() for p in b["image"]] == [[[0, 1], [2, 3]],
                                                [[4, 5], [6, 7]]]
    assert b["slide"] == ["s"] * 4
    with pytest.raises(ValueError, match="no multi-process runtime"):
        dist.global_batch({"image": np.zeros((2, 1))},
                          Mesh(["cpu"], spans_processes=True))


def test_sharded_servable_over_a_spanning_mesh_needs_a_runtime(scoring):
    """Over a mesh that spans processes a sharded servable's shards are
    every process's (tests/test_torch_lockstep.py runs it across two);
    in a single process such a mesh is refused."""
    with pytest.raises(ValueError, match="no multi-process runtime"):
        serve.ShardedServable(scoring[2], mesh=Mesh(
            ["cpu"], spans_processes=True))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
