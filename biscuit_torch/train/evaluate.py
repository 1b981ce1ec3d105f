"""External evaluation: run a saved model over an evaluation project.

Counterpart of ``biscuit_tpu/train/evaluate.py`` (the stand-in for
``sf.Project.evaluate``; SURVEY.md §2.3 E10). Writes the eval-dir
contract of SURVEY.md §2.4, ``{NNNNN-eval-}{outcome}-{label}-HP0_epoch{E}/``
holding ``results_log.csv``, ``patient_predictions_{outcome}_eval.csv``,
``slide_predictions_{outcome}_eval.csv`` and ``tile_predictions_eval.csv``,
so the JAX package's readers (``utils.find_eval``, whose slice of the
first 11 characters the prefix matches, and the results readers) read
what this writes.

Under a multi-process runtime (``parallel/distributed.py``) the main
process evaluates and publishes the metrics through the store; the
others wait for them instead of racing for the eval dir and its CSVs.
``collective=False`` opts out, for an evaluation that only this process
runs (the fold scheduling of ``Experiment.run`` claims evaluations one
by one).
"""

from __future__ import annotations

import json
import os
from os.path import basename, join
from typing import Dict, Optional

import pandas as pd

from ..stats.roc import auc_score, average_precision
from ..utils import tile_predictions_frame
from ..utils_log import log
from .trainer import group_predictions_frame, load_checkpoint, predict_tiles


def _next_eval_number(eval_dir: str) -> int:
    existing = []
    for d in os.listdir(eval_dir):
        head = d.split("-", 1)[0]
        if head.isdigit():
            existing.append(int(head))
    return max(existing) + 1 if existing else 0


def evaluate_project(
    project,
    model_path: str,
    outcome: str,
    filters: Optional[Dict] = None,
    save_predictions=True,
    max_tiles: Optional[int] = None,
    device=None,
    fuse_blocks: bool = False,
    collective: bool = True,
):
    """Evaluate a saved model over this project's dataset.

    Args:
        project: evaluation Project (annotations + tfrecords).
        model_path: path to a saved ``..._epoch{E}`` model dir.
        device: where the model runs (the card unless ``"cpu"``).
        fuse_blocks: the fully fused trunk, as in ``score_tiles``.
        collective: under a multi-process runtime, True (default) means
            every process calls this together: main evaluates and
            publishes the metrics. False: only this process evaluates,
            with no exchange.
    Returns:
        dict with ``eval_dir`` and level -> (auc, ap) for ``tile``,
        ``slide`` and ``patient``; writes the eval dir.
    """
    from ..parallel import distributed as dist

    # One hour covers an external evaluation of the full cohort.
    multiproc = dist.process_count() > 1 and collective
    if multiproc and not dist.is_main():
        results = json.loads(dist.broadcast_from_main(
            "eval_results", None, timeout_ms=3_600_000))
        # JSON turns the (auc, ap) tuples into lists; restore them.
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in results.items()}

    model, hp, meta = load_checkpoint(model_path, device)
    label = meta["label"]
    epoch_name = basename(model_path.rstrip("/"))
    epoch = int(epoch_name.split("epoch")[-1])

    dataset = project.dataset(hp.tile_px, hp.tile_um, filters=filters)
    labels, _unique = dataset.labels(outcome)
    patients = dataset.patients()
    tfrecords = dataset.tfrecords()
    log.info(f"Evaluating {label} on {project.name}: {len(tfrecords)} slides")

    n = _next_eval_number(project.eval_dir)
    # Prefix is exactly 11 chars ('{NNNNN}-eval-'): find_eval slices o[11:].
    out_dir = join(
        project.eval_dir, f"{n:05d}-eval-{outcome}-{label}-HP0_epoch{epoch}"
    )
    os.makedirs(out_dir, exist_ok=True)

    df, probs, unc = predict_tiles(model, hp, tfrecords, labels,
                                   max_tiles=max_tiles, device=device,
                                   fuse_blocks=fuse_blocks)

    if save_predictions:
        tile_predictions_frame(outcome, df, probs, unc).to_csv(
            join(out_dir, "tile_predictions_eval.csv"), index=False
        )
    pt_df = group_predictions_frame(df, probs, patients, "patient")
    pt_df.to_csv(
        join(out_dir, f"patient_predictions_{outcome}_eval.csv"), index=False
    )
    sl_df = group_predictions_frame(df, probs, patients, "slide")
    sl_df.to_csv(
        join(out_dir, f"slide_predictions_{outcome}_eval.csv"), index=False
    )

    t_auc = auc_score(df["y_true"], probs[:, 1])
    t_ap = average_precision(df["y_true"], probs[:, 1])
    s_auc = auc_score(sl_df["y_true1"], sl_df["percent_tiles_positive1"])
    s_ap = average_precision(
        sl_df["y_true1"], sl_df["percent_tiles_positive1"]
    )
    p_auc = auc_score(pt_df["y_true1"], pt_df["percent_tiles_positive1"])
    p_ap = average_precision(
        pt_df["y_true1"], pt_df["percent_tiles_positive1"]
    )

    pd.DataFrame(
        [
            {
                "model_name": f"{outcome}-{label}-HP0_epoch{epoch}",
                "patient_auc": json.dumps({outcome: [p_auc]}),
                "patient_ap": json.dumps({outcome: [p_ap]}),
                "slide_auc": json.dumps({outcome: [s_auc]}),
                "slide_ap": json.dumps({outcome: [s_ap]}),
                "tile_auc": json.dumps({outcome: [t_auc]}),
                "tile_ap": json.dumps({outcome: [t_ap]}),
            }
        ]
    ).to_csv(join(out_dir, "results_log.csv"), index=False)

    results = {
        "eval_dir": out_dir,
        "tile": (t_auc, t_ap),
        "slide": (s_auc, s_ap),
        "patient": (p_auc, p_ap),
    }
    if multiproc:
        dist.broadcast_from_main("eval_results", json.dumps(results),
                                 timeout_ms=3_600_000)
    return results
