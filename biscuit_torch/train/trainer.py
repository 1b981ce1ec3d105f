"""Training step, checkpoints and tile predictions of the port.

Counterpart of ``biscuit_tpu/train/trainer.py`` without its training
loop: ``lr_schedule`` and ``make_optimizer`` (Adam or SGD with the
continuous 0.98/512 exponential decay), ``preprocess`` (normalizer, then
per-image standardization), ``make_train_step`` (uint8 batch -> JPEG ->
normalize -> augment -> Xception forward/backward -> masked
cross-entropy -> optimizer update), ``save_checkpoint``/
``load_checkpoint`` in the JAX package's on-disk format, and the
prediction writers: ``score_tiles``/``predict_tiles`` over tfrecords
(the ``tile_predictions`` contract) and ``group_predictions_frame``.
The training loop around the step
(``train_project``, early stopping) is not ported yet.

A saved model directory holds ``params.json`` (``{"hp": ..., "outcome":
..., "label": ...}``) and ``model.msgpack`` (Flax ``to_bytes`` of
``{"params", "batch_stats"}``), so either package loads the other's.
"""

from __future__ import annotations

import json
import os
from os.path import join
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import augment_batch, jpeg_augment_batch
from ..data.normalize import make_normalizer, per_image_standardization
from ..data.pipeline import PrefetchBatcher, TileBatcher
from ..device import resolve_device
from ..hp import ModelParams
from ..models.convert import from_flax, read_msgpack, to_flax, write_msgpack
from ..models.xception import build_model


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
                    backend: str = "auto", device=None):
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
    jpeg = bool(hp.augment) and "j" in hp.augment
    if fused_trunk is None:
        fused_trunk = dev.type == "cuda" and fused_train_applicable(model)

    def train_step(images, labels, mask, generator=None):
        images, labels, mask = (torch.as_tensor(t).to(dev)
                                for t in (images, labels, mask))
        model.train()
        tx.zero_grad()
        raw = jpeg_augment_batch(images, generator) if jpeg else images
        x = preprocess(raw, normalizer)
        if hp.augment:
            x = augment_batch(x, generator, hp.augment)
        if fused_trunk:
            feats, updates = trunk_train_apply(model.backbone, x, backend)
            logits = model.head(feats, generator=generator)
        else:
            logits = model(x, generator=generator)
        labels = labels.long()
        mask = mask.float()
        ce = F.cross_entropy(logits, labels.clamp(min=0), reduction="none")
        denom = mask.sum().clamp_min(1.0)
        loss = (ce * mask).sum() / denom
        acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
        loss.backward()
        tx.step()
        if fused_trunk:
            apply_stat_updates(model.backbone, updates)
        return {"loss": loss.detach(), "acc": acc.detach()}

    return train_step


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

