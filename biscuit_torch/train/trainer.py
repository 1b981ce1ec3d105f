"""Training loop, step, checkpoints and tile predictions of the port.

Counterpart of ``biscuit_tpu/train/trainer.py``:
``lr_schedule`` and ``make_optimizer`` (Adam or SGD with the continuous
0.98/512 exponential decay), ``init_model`` (Flax's initialization),
``preprocess`` (normalizer, then per-image standardization),
``make_train_step`` (uint8 batch -> JPEG -> normalize -> augment ->
Xception forward/backward -> masked cross-entropy -> optimizer update),
``make_val_metrics_step`` (the early-stop check), ``save_checkpoint``/
``load_checkpoint`` in the JAX package's on-disk format, the prediction
writers (``score_tiles``/``predict_tiles`` over tfrecords, the
``tile_predictions`` contract, and ``group_predictions_frame``), and the
training loop ``train_project``: k-fold splits, the model-dir contract
of SURVEY.md §2.4, early stopping on accuracy, per-epoch validation
predictions and in-run checkpoints (``train/checkpoint.py``). Over a
mesh of several devices, or one that spans processes, one model is
trained in lockstep by a group of ranks (``parallel/lockstep.py``): each
rank reads its shard of the tile stream and steps on its rows of the
group's batch, with the group's BatchNorm statistics, loss and summed
gradients; main (rank 0) writes the model directory.

A saved model directory holds ``params.json`` (``{"hp": ..., "outcome":
..., "label": ...}``) and ``model.msgpack`` (Flax ``to_bytes`` of
``{"params", "batch_stats"}``), so either package loads the other's.
"""

from __future__ import annotations

import json
import math
import os
import threading
from os.path import join
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import (
    apply_augment,
    jpeg_apply,
    jpeg_on_host,
    sample_augment,
    sample_jpeg,
)
from ..data.normalize import make_normalizer, per_image_standardization
from ..data.pipeline import PrefetchBatcher, TileBatcher
from ..device import resolve_device
from ..hp import ModelParams
from ..models.convert import from_flax, read_msgpack, to_flax, write_msgpack
from ..models.resnet import BasicBlock, BottleneckBlock
from ..models.xception import BatchNorm, Conv, bn_group, build_model
from ..stats.roc import auc_score, average_precision
from ..tracing import span
from ..utils_log import log
from .checkpoint import RunCheckpointer
from .splits import kfold_split, train_val_slides


def lr_schedule(hp: ModelParams):
    """Keras ExponentialDecay (continuous): lr * rate^(step/steps)."""
    return lambda step: hp.learning_rate * (
        hp.learning_rate_decay ** (step / hp.learning_rate_decay_steps))


class ScheduledOptimizer:
    """A torch optimizer whose learning rate follows a schedule of its
    update count, read before each update as optax reads its count: the
    first update uses step 0."""

    def __init__(self, opt: torch.optim.Optimizer, schedule):
        self.opt = opt
        self.schedule = schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def make_optimizer(hp: ModelParams, params) -> ScheduledOptimizer:
    """``optax.adam`` (eps 1e-8 outside the square root, as torch's Adam
    adds it) or ``optax.sgd`` with momentum 0.9, on ``lr_schedule``."""
    params = list(params)
    schedule = lr_schedule(hp)
    name = hp.optimizer.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                               eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=schedule(0), momentum=0.9)
    else:
        raise ValueError(f"Unsupported optimizer {hp.optimizer}")
    return ScheduledOptimizer(opt, schedule)


# Standard deviation of the standard normal truncated to [-2, 2], by which
# Flax's truncated-normal initializers divide their scale.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight, fan_in: int, generator) -> None:
    """Flax's ``lecun_normal``: a normal of standard deviation
    sqrt(1 / fan_in) / _TRUNC_STD truncated to two of its standard
    deviations, drawn by the inverse CDF from ``generator``."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    lo, hi = (0.5 * (1 + math.erf(z / 2 ** 0.5)) for z in (-2.0, 2.0))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(2 * (lo + (hi - lo) * u) - 1) * 2 ** 0.5
    weight.copy_(z.clamp_(-2.0, 2.0) * std)


def init_model(model, hp: ModelParams, generator):
    """Initialize ``model`` in place as the JAX package's ``init_model``
    does (Flax's defaults) and return it: LeCun-normal conv and dense
    kernels (truncated normal, the same distribution as Flax's; the
    draws are ``generator``'s, not JAX's), zero dense biases, BatchNorm
    scale 1 and bias 0 with running mean 0 and variance 1.
    ``train_project`` calls it with a CPU ``torch.Generator`` seeded from
    the fold's seed, before the model moves to its device; it is the one
    seam a test replaces to start both packages from the same weights.
    (``chip_smoke.init_random_`` draws untruncated LeCun-normal convs and
    BatchNorm statistics away from identity, for kernel checks.)
    A ResNet block's last BatchNorm starts at scale 0, as Flax's
    ``scale_init=zeros`` in the JAX ``models/resnet.py``.

    With ``hp.pretrained`` ('imagenet' or a path), the trunk is then
    grafted from the staged Keras weights
    (``models/pretrained.resolve_pretrained_path``); the head keeps its
    fresh initialization (``include_top=False``)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif isinstance(mod, torch.nn.Linear):
                _lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
        for mod in model.modules():
            if isinstance(mod, (BasicBlock, BottleneckBlock)):
                mod.last_bn.weight.zero_()
    if getattr(hp, "pretrained", None):
        from ..models.pretrained import (
            load_pretrained,
            resolve_pretrained_path,
        )

        path = resolve_pretrained_path(hp.pretrained)
        load_pretrained(model, path)
        log.info(f"Initialized backbone from staged weights: {path}")
    return model


def preprocess(images_u8, normalizer):
    """uint8 NHWC batch -> standardized f32, the plain chain (the fused
    preprocess kernel is for inference)."""
    x = images_u8.float()
    if normalizer is not None:
        x = normalizer(x)
    return per_image_standardization(x)


def make_eval_step(model, normalizer):
    """``images -> softmax`` of the eval-mode forward of a uint8 NHWC
    batch (the plain preprocess chain, as the JAX ``make_eval_step``)."""

    def eval_step(images):
        with torch.inference_mode():
            logits = model(preprocess(images, normalizer))
            return torch.softmax(logits, dim=-1)

    return eval_step


def make_train_step(model, tx: ScheduledOptimizer, hp: ModelParams,
                    normalizer, fused_trunk: Optional[bool] = None,
                    backend: str = "auto", device=None, group=None):
    """The training step of ``hp`` on ``model`` and ``tx``, on ``device``
    (the card unless ``device="cpu"``; without a card it raises). The
    model must already be there; the batch is moved there.

    The JAX step threads (params, batch_stats, opt_state) through its
    arguments and results; here they are the model's parameters and
    BatchNorm buffers and ``tx``'s state, updated in place. So
    ``train_step(images, labels, mask, generator=None)`` takes a uint8
    (N, H, W, 3) batch, integer labels (negative = padding), a float mask
    and the generator of the step's random draws (JPEG, augmentation,
    dropout; on ``device``), and returns ``{"loss", "acc"}``; the
    gradients stay in the parameters' ``.grad``.

    ``fused_trunk=None`` runs the fused-backward trunk
    (``train/fused_train.py``, unit backwards on the hand-written kernel
    named by ``backend``) on the card when the model is a bf16 Xception,
    and the module path (autograd through ``models/xception.py``)
    otherwise.

    With a ``group`` (``parallel/lockstep.Group``) of several ranks, the
    batch is this rank's rows of the group's batch (rank r holds rows r*n
    to r*n + n - 1), and the step is the group's: its random draws are
    made at the group's batch shape from the same-seeded generator on
    every rank, of which each keeps its rows; the BatchNorm statistics,
    the mask sum of the loss and accuracy, and the gradients (one
    flattened bucket, before the optimizer) are summed over the group.
    So every rank makes the same update, and N ranks compute what one
    computes on the group's batch. ``train_step(..., stop=)`` then also
    returns ``"stop"``: whether any rank passed ``stop=True``.

    Under a profiler a step records the spans ``train.copy``,
    ``train.augment``, ``train.forward``, ``train.backward`` and
    ``train.optimizer`` (``tracing``).
    """
    from .fused_train import (
        apply_stat_updates,
        fused_train_applicable,
        trunk_train_apply,
    )

    dev = resolve_device(device)
    elsewhere = {str(t.device) for t in model.state_dict().values()
                 if t.device.type != dev.type
                 or (dev.index is not None and t.device.index != dev.index)}
    if elsewhere:
        raise ValueError(f"the model must be on {dev} to train there, but "
                         f"some of its tensors are on {sorted(elsewhere)}; "
                         f"move it with model.to(...) before make_optimizer")
    # 'j' runs here, on the raw batch, unless BISCUIT_JPEG_HOST=1 moved it
    # to the host codec (TileBatcher's jpeg_aug).
    jpeg = bool(hp.augment) and "j" in hp.augment and not jpeg_on_host()
    if fused_trunk is None:
        fused_trunk = dev.type == "cuda" and fused_train_applicable(model)

    lockstep = group is not None and group.size > 1
    bn_ranks = group if lockstep else None

    def train_step(images, labels, mask, generator=None, stop=False):
        with span("train.copy"):
            images, labels, mask = (torch.as_tensor(t).to(dev)
                                    for t in (images, labels, mask))
        model.train()
        with span("train.optimizer"):
            tx.zero_grad()
        n = images.shape[0]
        start, total = (group.rank * n, group.size * n) if lockstep else (
            0, n)

        def mine(draws: dict) -> dict:
            return {k: v[start:start + n] for k, v in draws.items()}

        with span("train.augment"):
            raw = images
            if jpeg:
                apply, q = sample_jpeg(total, generator, device=dev)
                raw = jpeg_apply(images, apply[start:start + n],
                                 q[start:start + n])
            x = preprocess(raw, normalizer)
            if hp.augment:
                x = apply_augment(x, mine(sample_augment(total, generator,
                                                         hp.augment, dev)))
        with span("train.forward"):
            with bn_group(bn_ranks):
                if fused_trunk:
                    feats, updates = trunk_train_apply(model.backbone, x,
                                                       backend)
                    logits = model.head(feats, generator=generator,
                                        rows=(start, total))
                else:
                    logits = model(x, generator=generator,
                                   rows=(start, total))
            labels = labels.long()
            mask = mask.float()
            ce = F.cross_entropy(logits, labels.clamp(min=0),
                                 reduction="none")
            hits = ((logits.argmax(-1) == labels) * mask).sum()
            if not lockstep:
                denom = mask.sum().clamp_min(1.0)
                loss = (ce * mask).sum() / denom
                acc = hits / denom
        out = {}
        with span("train.backward"):
            if lockstep:
                sums = group.all_reduce_sum([torch.stack([
                    mask.sum(), (ce * mask).sum().detach(), hits,
                    mask.new_tensor(float(bool(stop)))])])[0]
                denom = sums[0].clamp_min(1.0)
                ((ce * mask).sum() / denom).backward()
                loss, acc = sums[1] / denom, sums[2] / denom
                group.all_reduce_grads(model.parameters())
                out["stop"] = bool(sums[3] > 0)
            else:
                loss.backward()
        with span("train.optimizer"):
            tx.step()
            if fused_trunk:
                apply_stat_updates(model.backbone, updates)
        return {"loss": loss.detach(), "acc": acc.detach(), **out}

    return train_step


def make_val_metrics_step(model, normalizer, group=None):
    """``(images, labels, mask) -> (correct, total)`` of the eval-mode
    forward of a uint8 NHWC batch, for the mid-training early-stop check:
    the plain preprocess and the module path (no kernel runs here, as no
    Pallas kernel runs in the JAX step), the counts as device scalars on
    the model's device. It leaves the model in eval mode; the training
    step sets train mode again. With a ``group`` of several ranks the
    counts are the group's, so that every rank takes the same early-stop
    decision."""

    def val_metrics(images, labels, mask):
        dev = next(model.parameters()).device
        images, labels, mask = (torch.as_tensor(t).to(dev)
                                for t in (images, labels, mask))
        mask = mask.float()
        model.eval()
        with torch.inference_mode():
            logits = model(preprocess(images, normalizer))
            correct = ((logits.argmax(-1) == labels.long()) * mask).sum()
        if group is not None and group.size > 1:
            return tuple(group.all_reduce_sum([torch.stack(
                [correct.float(), mask.sum()])])[0])
        return correct, mask.sum()

    return val_metrics


def save_checkpoint(model_dir: str, model, hp: ModelParams, epoch: int,
                    outcome: str, label: str, kfold: Optional[int],
                    outcome_labels: Optional[list] = None) -> str:
    """Save weights into the ``{outcome}-{label}-HP0[-kfold{k}]_epoch{E}``
    subdirectory, as the JAX ``save_checkpoint`` does; returns its path."""
    tail = "" if kfold is None else f"-kfold{kfold}"
    sub = join(model_dir, f"{outcome}-{label}-HP0{tail}_epoch{epoch}")
    os.makedirs(sub, exist_ok=True)
    params, batch_stats = to_flax(model.state_dict())
    write_msgpack(join(sub, "model.msgpack"),
                  {"params": params, "batch_stats": batch_stats})
    meta = {"hp": hp.to_dict(), "outcome": outcome, "label": label}
    if outcome_labels is not None:
        meta["outcome_labels"] = list(outcome_labels)
    with open(join(sub, "params.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return sub


def load_checkpoint(model_path: str, device=None):
    """Load (model, hp, meta) from a saved model dir; the model is in eval
    mode on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(join(model_path, "params.json")) as f:
        meta = json.load(f)
    hp = ModelParams.from_dict(meta["hp"])
    model = build_model(hp)
    state = read_msgpack(join(model_path, "model.msgpack"))
    model.load_state_dict(from_flax(state["params"], state["batch_stats"]))
    return model.to(dev).eval(), hp, meta


def score_tiles(model, hp: ModelParams, tfrecords: List[str],
                labels: Dict[str, int], batch_size: Optional[int] = None,
                max_tiles: Optional[int] = None, device=None,
                fuse_blocks: bool = False):
    """Score every tile of ``tfrecords`` in order -> ``(rows, probs, unc)``.

    ``rows`` holds numpy columns ``slide``, ``loc_x``, ``loc_y`` and
    ``y_true`` (the tile's slide label from ``labels``, -1 where absent),
    ``probs`` is (N, C) f32 and ``unc`` (N, C) f32 or None; the padding
    rows of the last batch are stripped. Tiles are read and decoded on
    the host a few batches ahead (``PrefetchBatcher``) and scored on
    ``device`` (the card unless ``device="cpu"``), where ``model`` is
    moved. With ``hp.uq`` each batch goes through one
    ``UncertaintyInterface`` (K = ``hp.uq_samples``; its dropout stream
    starts from seed 42, as the JAX package's from ``PRNGKey(42)``;
    ``fuse_blocks`` as there, the counterpart of the JAX package's
    ``BISCUIT_FUSED_BLOCKS``), else through
    ``make_eval_step`` with ``unc`` None. The outputs stay on the card
    and are copied back once, after the last batch."""
    dev = resolve_device(device)
    if hp.uq:
        from .uq import UncertaintyInterface

        score = UncertaintyInterface.from_model(
            model, hp, k=hp.uq_samples, device=dev, seed=42,
            fuse_blocks=fuse_blocks)
    else:
        eval_step = make_eval_step(model.to(dev).eval(),
                                   make_normalizer(hp.normalizer))

        def score(images):
            return eval_step(images), None

    batcher = PrefetchBatcher(
        TileBatcher(tfrecords, labels, batch_size=batch_size or hp.batch_size,
                    shuffle=False, infinite=False, max_tiles=max_tiles,
                    tile_px=hp.tile_px),
        depth=3,
    )
    rows = {"slide": [], "loc_x": [], "loc_y": [], "y_true": []}
    masks, probs, unc = [], [], []
    try:
        for batch in batcher:
            m = batch["mask"]
            p, u = score(torch.from_numpy(batch["image"]).to(dev))
            masks.append(m)
            probs.append(p)
            if u is not None:
                unc.append(u)
            rows["slide"] += [s for s, keep in zip(batch["slide"], m) if keep]
            rows["loc_x"].append(batch["loc"][m, 0])
            rows["loc_y"].append(batch["loc"][m, 1])
            rows["y_true"].append(batch["label"][m])
    finally:
        batcher.close()
    keep = np.concatenate(masks)

    def host(outs):
        return torch.cat(outs).float().cpu().numpy()[keep]

    rows = {"slide": np.asarray(rows["slide"], dtype=object),
            **{k: np.concatenate(rows[k]).astype(np.int64)
               for k in ("loc_x", "loc_y", "y_true")}}
    return rows, host(probs), host(unc) if unc else None


def predict_tiles(model, hp: ModelParams, tfrecords: List[str],
                  labels: Dict[str, int], batch_size: Optional[int] = None,
                  max_tiles: Optional[int] = None, device=None,
                  fuse_blocks: bool = False):
    """``score_tiles`` as the JAX ``predict_tiles`` returns it:
    ``(rows DataFrame, probs, unc)``, the frame behind the
    ``tile_predictions`` CSV contract (``utils.tile_predictions_frame``)."""
    import pandas as pd

    rows, probs, unc = score_tiles(
        model, hp, tfrecords, labels, batch_size=batch_size,
        max_tiles=max_tiles, device=device, fuse_blocks=fuse_blocks)
    return pd.DataFrame(rows), probs, unc


def group_predictions_frame(tile_df, probs, patients: Dict[str, str],
                            level_name: str):
    """Patient/slide-level predictions: y_true1 + percent_tiles_positive1
    (the column contract the JAX ``utils.read_group_predictions`` reads),
    groups in order of first appearance."""
    import pandas as pd

    df = pd.DataFrame(
        {
            "slide": tile_df["slide"],
            "y_true": tile_df["y_true"],
            "pos": (probs[:, 1] >= 0.5).astype(np.float64),
            "y_pred1": probs[:, 1],
        }
    )
    if level_name == "patient":
        df["group"] = df["slide"].map(patients)
    else:
        df["group"] = df["slide"]
    g = df.groupby("group", sort=False).agg(
        y_true1=("y_true", "mean"),
        percent_tiles_positive1=("pos", "mean"),
        n_tiles=("pos", "size"),
    ).reset_index().rename(columns={"group": level_name})
    # uint8 cast of the group mean, as threshold.process_group_predictions
    # casts it (the reference assumes label purity within a group).
    g["y_true1"] = g["y_true1"].to_numpy().astype(np.uint8)
    return g



def _write_predictions(df, path_base: str, fmt) -> None:
    """Write a predictions frame in the requested format.

    fmt: 'csv' (default; also for True), 'parquet' (writes
    ``{base}.parquet.gzip``, the slideflow 1.2 variant the reference reads
    back at utils.py:216-221), or falsy to skip.
    """
    if not fmt:
        return
    if fmt == "parquet":
        df.to_parquet(path_base + ".parquet.gzip", compression="gzip")
    else:
        df.to_csv(path_base + ".csv", index=False)


def _level_metrics(y_true, y_score):
    return (
        auc_score(np.asarray(y_true), np.asarray(y_score)),
        average_precision(np.asarray(y_true), np.asarray(y_score)),
    )


# Model directories. One lock so that concurrent trainings in a process
# allocate distinct run numbers; creating the directory inside the lock
# makes it visible to the next _next_run_number scan.
_MODEL_DIR_LOCK = threading.Lock()

# Set by the SIGTERM trap of a lockstep training, read by every rank of
# this process (the other ranks are threads, which receive no signal).
_PREEMPTED = threading.Event()


def _next_run_number(models_dir: str) -> int:
    existing = []
    for d in os.listdir(models_dir):
        head = d.split("-", 1)[0]
        if head.isdigit():
            existing.append(int(head))
    return max(existing) + 1 if existing else 0


def _model_dir_name(n: int, outcome: str, label: str,
                    kfold: Optional[int]) -> str:
    tail = "" if kfold is None else f"-kfold{kfold}"
    return f"{n:05d}-{outcome}-{label}-HP0{tail}"


def train_project(
    project,
    outcome: str,
    exp_label: str,
    filters: Optional[Dict] = None,
    params: Optional[ModelParams] = None,
    splits: Optional[str] = None,
    val_k: Optional[List[int]] = None,
    val_k_fold: int = 3,
    val_strategy: str = "k-fold",
    save_predictions="csv",
    validate_on_batch: int = 32,
    validation_steps: int = 32,
    save_model: bool = False,
    steps_per_epoch_override: Optional[int] = None,
    seed: int = 0,
    max_tiles: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    device=None,
    fuse_blocks: bool = False,
    mesh=None,
):
    """Train model(s) for an experiment label; ``sf.Project.train``'s
    counterpart, as the JAX package's ``train_project``.

    ``val_strategy`` 'k-fold' trains fold k of ``val_k`` (all
    ``val_k_fold`` folds by default) with seed ``seed + k`` on the
    site-preserving splits cached in ``splits`` (default
    ``splits_{exp_label}.json`` under the project root); 'none' trains
    one model on every slide with ``seed``.

    Args (beyond the reference contract):
        checkpoint_every: save an in-run checkpoint every N steps and
            resume from the latest one when the run is relaunched.
        device: where the model trains and predicts: the card unless
            ``device="cpu"`` (without a card it raises).
        fuse_blocks: validation predictions through the fully fused
            trunk (``UncertaintyInterface``'s ``fuse_blocks``; the JAX
            package's ``BISCUIT_FUSED_BLOCKS``).
        mesh: a ``parallel.mesh.Mesh`` to train on instead of
            ``device``. One device (a submesh of the ``SubmeshScheduler``)
            trains there. Several devices, or a mesh that spans processes
            (every process of the runtime calls ``train_project`` with its
            own devices), train each model in lockstep, one rank a device
            (``parallel/lockstep.py``): ``hp.batch_size`` is the group's
            batch and must divide by the number of ranks; each rank reads
            its shard of the tile stream; main (rank 0) allocates and
            writes the model directory, the checkpoints and the
            predictions, which it makes on its own device while the others
            wait.

    Returns the list of model directories it wrote.
    """
    from ..parallel import distributed
    from ..parallel.lockstep import mesh_ranks, run_ranks

    lockstep = mesh is not None and (
        mesh.size > 1 or distributed.mesh_spans_processes(mesh))
    if mesh is not None:
        device = mesh.devices[0]
    dev = resolve_device(device)
    hp = params if params is not None else ModelParams()
    if lockstep and hp.batch_size % mesh_ranks(mesh)[1]:
        raise ValueError(f"batch_size {hp.batch_size} does not divide over "
                         f"the {mesh_ranks(mesh)[1]} ranks of {mesh}")
    dataset = project.dataset(hp.tile_px, hp.tile_um, filters=filters)
    labels, unique = dataset.labels(outcome)
    patients = dataset.patients()
    by_slide = {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in dataset.tfrecords()
    }
    log.info(f"Training {exp_label}: {len(by_slide)} slides, classes {unique}")
    common = dict(
        validate_on_batch=validate_on_batch,
        validation_steps=validation_steps, save_model=save_model,
        steps_per_epoch_override=steps_per_epoch_override,
        max_tiles=max_tiles, checkpoint_every=checkpoint_every,
        save_predictions=save_predictions, outcome_labels=unique,
        fuse_blocks=fuse_blocks,
    )
    slides = [s for s in dataset.slides() if s in by_slide]
    if val_strategy == "k-fold":
        splits_path = join(project.root, splits or f"splits_{exp_label}.json")

        def split():
            return kfold_split(slides=slides, labels=labels,
                               sites=dataset.sites(), k=val_k_fold,
                               seed=seed, splits_path=splits_path)

        # Over processes, main writes the cached split and the others
        # read it.
        spans = lockstep and distributed.mesh_spans_processes(mesh)
        folds = split() if not spans or distributed.is_main() else None
        if spans:
            distributed.barrier("kfold_split")
            folds = folds or split()
        jobs = [(*train_val_slides(folds, k), k, seed + k)
                for k in (val_k if val_k else range(1, val_k_fold + 1))]
    elif val_strategy == "none":
        jobs = [(slides, [], None, seed)]
    else:
        raise ValueError(f"Unknown val_strategy {val_strategy}")

    def train_all(device, group=None):
        if group is not None:
            _warm_kernels(device)
            group.barrier("kernels_built")
            group.connect()
        return [_train_single(project, outcome, exp_label, hp, labels,
                              patients, by_slide, train_slides, val_slides,
                              kfold=k, seed=s, device=device, group=group,
                              **common)
                for train_slides, val_slides, k, s in jobs]

    if lockstep:
        return run_ranks(mesh, lambda group: train_all(
            resolve_device(group.device), group), name="train_project")
    return train_all(dev)


def _warm_kernels(dev) -> None:
    """Build the kernels of the training step before a group's first
    collective, so that ``nvcc`` on one rank cannot hold the others past
    the backend's connect timeout (the JAX package compiles its step
    programs ahead for the same reason)."""
    if dev.type == "cuda":
        from ..ops import _build

        _build.load(_build.SOURCE["unit_bwd_strips"])


def _model_dir(models_dir: str, outcome: str, exp_label: str,
               kfold: Optional[int]) -> str:
    """The run's directory: an existing one for this (outcome, label,
    kfold) that died mid-run (no results_log.csv) is reused, so that its
    in-run checkpoints resume it; completed ones never are."""
    tail = "" if kfold is None else f"-kfold{kfold}"
    wanted_suffix = f"{outcome}-{exp_label}-HP0{tail}"
    with _MODEL_DIR_LOCK:
        incomplete = [
            d for d in os.listdir(models_dir)
            if d[6:] == wanted_suffix
            and not os.path.exists(join(models_dir, d, "results_log.csv"))
        ]
        if incomplete:
            model_dir = join(models_dir, sorted(incomplete)[-1])
            log.info(f"Reusing incomplete run dir {model_dir}")
        else:
            model_dir = join(models_dir, _model_dir_name(
                _next_run_number(models_dir), outcome, exp_label, kfold))
        os.makedirs(model_dir, exist_ok=True)
    return model_dir


def _train_single(
    project, outcome, exp_label, hp, labels, patients, by_slide,
    train_slides, val_slides, kfold, validate_on_batch, validation_steps,
    save_model, steps_per_epoch_override, seed, max_tiles,
    checkpoint_every=None, save_predictions="csv", outcome_labels=None,
    device=None, fuse_blocks=False, group=None,
):
    """Train one model (one fold) on ``device``, as one rank of ``group``
    when given; main writes the full §2.4 contract. Returns its model
    directory."""
    import signal
    import time

    import pandas as pd

    from ..utils import tile_predictions_frame

    dev = resolve_device(device)
    lockstep = group is not None
    main = not lockstep or group.is_main
    rank, ranks = (group.rank, group.size) if lockstep else (0, 1)
    local_bs = hp.batch_size // ranks
    model = init_model(build_model(hp), hp,
                       torch.Generator().manual_seed(seed)).to(dev)
    tx = make_optimizer(hp, model.parameters())
    normalizer = make_normalizer(hp.normalizer)
    train_step = make_train_step(model, tx, hp, normalizer, device=dev,
                                 group=group)
    val_metrics_step = make_val_metrics_step(model, normalizer, group)

    # Main allocates the run's directory; the other ranks receive its name.
    model_dir = (_model_dir(project.models_dir, outcome, exp_label, kfold)
                 if main else None)
    if lockstep:
        model_dir = group.broadcast_from_main("model_dir", model_dir)
    if main:
        pd.DataFrame(
            [{"slide": s, "dataset": "training"} for s in train_slides]
            + [{"slide": s, "dataset": "validation"} for s in val_slides]
        ).to_csv(join(model_dir, "slide_manifest.csv"), index=False)
        with open(join(model_dir, "params.json"), "w") as f:
            meta = {"hp": hp.to_dict(), "outcome": outcome,
                    "label": exp_label, "kfold": kfold}
            if outcome_labels is not None:
                meta["outcome_labels"] = list(outcome_labels)
            json.dump(meta, f, indent=2)
    train_tfr = [by_slide[s] for s in train_slides if s in by_slide]
    val_tfr = [by_slide[s] for s in val_slides if s in by_slide]

    train_batcher = TileBatcher(
        train_tfr, labels, batch_size=local_bs, shuffle=True,
        infinite=True, seed=seed,
        # 'j' runs in the training step by default; the host codec only
        # under BISCUIT_JPEG_HOST=1.
        jpeg_aug="j" in (hp.augment or "") and jpeg_on_host(),
        max_tiles=max_tiles, tile_px=hp.tile_px,
        shard=rank, num_shards=ranks,
    )
    steps_per_epoch = max(1, len(train_batcher) * ranks // hp.batch_size)
    if steps_per_epoch_override:
        steps_per_epoch = int(steps_per_epoch_override)
    if lockstep:
        # The shards' lengths may differ by a tile: every rank takes
        # main's epoch length, so that none steps alone.
        steps_per_epoch = int(group.broadcast_from_main(
            "steps_per_epoch", str(steps_per_epoch)))

    # A small held-out stream for the mid-training early-stop checks.
    val_batcher = None
    if val_tfr and hp.early_stop:
        val_batcher = TileBatcher(
            val_tfr, labels, batch_size=local_bs, shuffle=True,
            infinite=True, seed=seed + 1, max_tiles=max_tiles,
            tile_px=hp.tile_px, shard=rank, num_shards=ranks,
        )
        val_iter = iter(val_batcher)

    def feed(b):
        return b["image"], b["label"], np.asarray(b["mask"], np.float32)

    # Early stopping on accuracy, as the JAX package: every
    # `validate_on_batch` steps the validation accuracy is observed; after
    # `hp.ema_observations` observations an exponential moving average
    # starts at their mean and then moves with smoothing
    # `ema_smoothing / (1 + ema_observations)`. Training stops when the EMA
    # worsens and more than `hp.early_stop_patience` epochs have elapsed
    # (patience is an epoch floor).
    es_window: list = []
    es_ema = None
    es_alpha = hp.ema_smoothing / (1 + hp.ema_observations)
    early_stop_batch = None
    stopped = False
    results_rows, step_log = [], []
    step = 0

    # One generator on the device for the step's JPEG, augmentation and
    # dropout draws; an in-run checkpoint restores its state with the
    # model's and the optimizer's.
    gen = torch.Generator(device=dev).manual_seed(seed)
    ckpt = RunCheckpointer(model_dir, every=checkpoint_every, is_main=main)
    restore_step = None
    if lockstep and checkpoint_every:
        # Main scans the checkpoints; every rank restores the step it
        # names, read-only, so that the ranks resume alike.
        tok = group.broadcast_from_main(
            "ckpt_latest", str(ckpt.latest()) if main else None)
        restore_step = None if tok == "None" else int(tok)
    _, _, _, restored_step = ckpt.maybe_restore(model, tx, gen,
                                                step=restore_step)

    # BISCUIT_PROFILE=1: main's trace of the fold, in which the step's
    # spans and `batcher.wait` (`tracing`) show where its host time goes.
    profiler = None
    if main and os.environ.get("BISCUIT_PROFILE") == "1":
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        profiler.start()

    # The host reads and decodes the next batches while the device steps.
    train_stream = PrefetchBatcher(train_batcher, depth=3)
    train_iter = iter(train_stream)
    t_last = time.perf_counter()

    # Preemption: on SIGTERM, checkpoint at the next step boundary, then
    # exit through the previous handler; the relaunch resumes losing at
    # most one step. Armed only with in-run checkpoints on and on the main
    # thread (signal.signal is illegal elsewhere); BISCUIT_PREEMPT_SAVE=0
    # disables it. In lockstep the step sums every rank's flag, so that
    # the ranks stop at the same step: main saves, the ranks meet at a
    # store barrier, and each process exits through its handler.
    preempt = [False]
    prev_sigterm = None
    armed = bool(checkpoint_every
                 and os.environ.get("BISCUIT_PREEMPT_SAVE", "1") != "0")
    trap = armed and threading.current_thread() is threading.main_thread()
    if trap:
        _PREEMPTED.clear()

        def on_sigterm(signum, frame):
            preempt[0] = True
            _PREEMPTED.set()
            log.warning("SIGTERM received: checkpointing at the next step "
                        "boundary, then exiting")
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        for epoch in range(1, max(hp.epochs) + 1):
            for _ in range(steps_per_epoch):
                step += 1
                if step <= restored_step:
                    # Fast-forward without reading batches: the generator
                    # was restored at this step; the tile stream restarts
                    # from its seed.
                    continue
                if lockstep:
                    metrics = train_step(
                        *feed(next(train_iter)), gen,
                        stop=armed and _PREEMPTED.is_set())
                    stop = metrics["stop"]
                else:
                    metrics = train_step(*feed(next(train_iter)), gen)
                    stop = preempt[0]
                ckpt.save(step, model, tx, gen)
                if stop:
                    ckpt.save(step, model, tx, gen, force=True)
                    ckpt.wait()
                    if lockstep:
                        group.barrier("preempt_ckpt")
                    log.warning(f"preemption checkpoint committed at step "
                                f"{step}; re-raising SIGTERM")
                    if not trap:    # a rank's thread: its process exits
                        raise RuntimeError(f"preempted at step {step}")
                    signal.signal(signal.SIGTERM, prev_sigterm)
                    trap = False
                    os.kill(os.getpid(), signal.SIGTERM)
                if step % 10 == 0 or step == 1:
                    now = time.perf_counter()
                    step_log.append({
                        "step": step,
                        "epoch": epoch,
                        "loss": float(metrics["loss"]),
                        "acc": float(metrics["acc"]),
                        "lr": float(lr_schedule(hp)(step)),
                        "tiles_per_s": hp.batch_size
                        * (10 if step > 1 else 1) / (now - t_last),
                    })
                    t_last = now

                if (val_batcher is not None
                        and hp.early_stop_method == "accuracy"
                        and step % validate_on_batch == 0
                        and early_stop_batch is None):
                    correct = total = 0.0
                    for _ in range(max(1, validation_steps)):
                        c, t = val_metrics_step(*feed(next(val_iter)))
                        correct += float(c)
                        total += float(t)
                    val_acc = correct / max(total, 1)
                    if es_ema is None:
                        es_window.append(val_acc)
                        if len(es_window) >= hp.ema_observations:
                            es_ema = float(np.mean(es_window))
                    else:
                        last_ema = es_ema
                        es_ema = val_acc * es_alpha + es_ema * (1 - es_alpha)
                        if (es_ema < last_ema and step / steps_per_epoch
                                > hp.early_stop_patience):
                            early_stop_batch = step
                            stopped = True
                            log.info(f"Early stop at batch {step} (val acc "
                                     f"EMA {es_ema:.4f} < {last_ema:.4f})")
                            break

            # End of epoch. Skip epochs fully covered by a restored
            # checkpoint: the original run wrote their predictions, and
            # later-step weights would overwrite that record. Main
            # predicts over its own device; the other ranks wait for it
            # at a store barrier.
            record = epoch in hp.epochs or stopped
            if record and main and not (
                    step <= restored_step and not stopped):
                # On an early stop mid-epoch, record under the next declared
                # epoch, so that readers find tile_predictions_val_epoch{E}
                # for E in hp.epochs.
                later = [e for e in hp.epochs if e >= epoch]
                epoch = (epoch if epoch in hp.epochs
                         else (min(later) if later else max(hp.epochs)))
                row = {"model_name": f"{outcome}-{exp_label}-HP0_epoch{epoch}"}
                if val_tfr:
                    df, probs, unc = predict_tiles(
                        model, hp, val_tfr, labels, max_tiles=max_tiles,
                        device=dev, fuse_blocks=fuse_blocks)
                    _write_predictions(
                        tile_predictions_frame(outcome, df, probs, unc),
                        join(model_dir, f"tile_predictions_val_epoch{epoch}"),
                        save_predictions)
                    levels = {}
                    for level in ("patient", "slide"):
                        g = group_predictions_frame(df, probs, patients, level)
                        _write_predictions(g, join(
                            model_dir,
                            f"{level}_predictions_{outcome}_val_epoch{epoch}"),
                            save_predictions)
                        levels[level] = _level_metrics(
                            g["y_true1"], g["percent_tiles_positive1"])
                    levels["tile"] = _level_metrics(df["y_true"], probs[:, 1])
                    for level, (auc, ap) in levels.items():
                        row[f"{level}_auc"] = json.dumps({outcome: [auc]})
                        row[f"{level}_ap"] = json.dumps({outcome: [ap]})
                if early_stop_batch is not None:
                    row["early_stop_batch"] = early_stop_batch
                results_rows.append(row)
                if save_model:
                    save_checkpoint(model_dir, model, hp, epoch, outcome,
                                    exp_label, kfold,
                                    outcome_labels=outcome_labels)
            if lockstep and record:
                group.barrier("epoch_artifacts")
            if stopped:
                break  # an early stop ends the remaining epochs
    finally:
        if trap:
            signal.signal(signal.SIGTERM, prev_sigterm)
        train_stream.close()
        if val_batcher is not None:
            val_batcher.close()
        ckpt.close()
        if profiler is not None:
            profiler.stop()

    if profiler is not None:
        os.makedirs(join(model_dir, "profile"), exist_ok=True)
        profiler.export_chrome_trace(join(model_dir, "profile", "trace.json"))
    if main:
        if step_log:
            pd.DataFrame(step_log).to_csv(join(model_dir, "train_log.csv"),
                                          index=False)
        pd.DataFrame(results_rows).to_csv(join(model_dir, "results_log.csv"),
                                          index=False)
    if lockstep:
        group.barrier("fold_written")
    return model_dir
