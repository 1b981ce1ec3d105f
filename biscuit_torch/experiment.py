"""Experiment supervisor: the published dataset-size-ladder study end to end.

The port's copy of ``biscuit_tpu/experiment.py`` (reference BISCUIT
``experiment.py``): the ``ALL_EXP`` ladder and the published grid
(``published_matrix``), and ``Experiment`` with ``add``, ``config``,
``train``, ``train_nested_cv``, the 6-step ``run``,
``thresholds_from_nested_cv``, ``results``, ``plot_uq_calibration`` and
``display``. It trains through ``Project.train`` (``train_project``) and
evaluates through ``Project.evaluate`` (``evaluate_project``), so every
training and evaluation runs on the card unless ``train_kwargs`` holds
``device="cpu"``.

It keeps the JAX package's fixes over the reference: ``add`` is an
instance method and gives annotations without 'gan'/'site' columns
neutral defaults; the slide-level eval metrics read the slide-level
predictions file where it exists; ``plot_uq_calibration`` saves and
closes its figures and follows ``k``; ``display`` names each eval
figure by its project. Resumes are idempotent: every step checks
``model_exists``/``eval_exists`` first, a fold counts as done once its
``results_log.csv`` exists, and partial k-folds are completed fold by
fold.

Fold scheduling: with ``train_kwargs["n_submeshes"] = N`` the
independent (experiment, fold) trainings of a step run concurrently on
N disjoint device groups (``parallel/scheduler.py``): this process's
cards, or N copies of ``train_kwargs["device"]`` where that is given.
Under a multi-process runtime (``parallel/distributed.py``) the same
setting distributes the folds: each process claims folds through the
store and trains them on its own devices, and every step ends with a
status exchange, so one process's failure aborts all of them. Without
``n_submeshes`` a multi-process run trains each fold in lockstep over all
processes (``parallel/lockstep.py``): every process runs the protocol,
each training's ranks are this process's devices (``train_kwargs
["device"]`` where that is given) on a mesh that spans the processes,
main writes the annotations and the model directories, and step 6 is
evaluated by main and published to the others.
matplotlib, seaborn and scipy are imported only by the figure code.
"""

from __future__ import annotations

import os
import shutil
from os.path import exists, join
from statistics import mean
from typing import Dict

import numpy as np
import pandas as pd

from . import threshold, utils
from . import hp as biscuit_hp
from .errors import MatchError, ModelNotFoundError, ThresholdError
from .project import Project
from .utils_log import bold, log

# Dataset-size ladder: experiment id -> number of slides (experiment.py:21-45).
ALL_EXP = {
    "AA": "full",
    "U": 800, "T": 700, "S": 600, "R": 500,
    "A": 400, "L": 350, "M": 300, "N": 250,
    "D": 200, "O": 176, "P": 150, "Q": 126,
    "G": 100, "V": 90, "W": 80, "X": 70, "Y": 60, "Z": 50,
    "ZA": 40, "ZB": 30, "ZC": 20, "ZD": 10,
}

# Experiments below 100 slides skip UQ thresholding (experiment.py:577-579).
NO_UQ_EXPS = ("V", "W", "X", "Y", "Z", "ZA", "ZB", "ZC", "ZD")

FULL_EPOCH_EXPS = ("AA", "A", "D", "G")

# Published-grid subsets: the 3:1/10:1 class-ratio arm runs on 'AMDPGZ'
# (reference train.py:79-86) and the GAN-fraction arm on
# 'RALMNDOPQGWY' + ZA/ZC (train.py:89-96).
RATIO_EXPS = tuple("AMDPGZ")
GAN_EXPS = tuple("RALMNDOPQGWY") + ("ZA", "ZC")
GAN_FRACTIONS = (0.1, 0.2, 0.3, 0.4, 0.5)


def published_matrix(ladder=None, reg=True, orderings=True, ratio=True,
                     gan=True):
    """The complete published experiment grid as named config groups.

    Single source of truth for the matrix the reference constructs in
    BOTH train.py:61-96 and results.py:94-121 (duplicated there; shared
    here so the training and results CLIs can never drift apart):

    * ``reg1``/``reg2``/``rev1``/``rev2`` — the ladder forward/reverse
      over the two independent orderings (labels ``{}``, ``{}2``,
      ``{}_R``, ``{}_R2``);
    * ``ratio_3``/``ratio_10`` — 3:1 and 10:1 class-ratio arms over
      AMDPGZ, forward + reverse (labels ``{}_3``/``{}_R_3``/``{}_10``/
      ``{}_R_10``, each with its 'i' class-inverse);
    * ``gan`` — GAN fractions 10-50% over the 14-size subset, forward +
      reverse (labels ``{}_g10``..``{}_R_g50``).

    Returns an ordered dict of {group: {label: add-kwargs}} for the
    requested arms, restricted to ``ladder`` when given. Groups are in
    the reference's training order (train.py:95-96 runs them
    sequentially).
    """
    L = list(ALL_EXP) if ladder is None else [e for e in ALL_EXP
                                              if e in ladder]
    cfg = Experiment.config
    groups = {}
    if reg:
        groups["reg1"] = cfg("{}", L, 1, order="f")
        if orderings:
            groups["reg2"] = cfg("{}2", L, 1, order="f",
                                 order_col="order2")
            groups["rev1"] = cfg("{}_R", L, 1, order="r")
            groups["rev2"] = cfg("{}_R2", L, 1, order="r",
                                 order_col="order2")
    if ratio:
        r = [e for e in RATIO_EXPS if e in L]
        for rat in (3, 10):
            grp = cfg("{}_" + str(rat), r, rat, order="f")
            grp.update(cfg("{}_R_" + str(rat), r, rat, order="r"))
            groups[f"ratio_{rat}"] = grp
    if gan:
        g = [e for e in GAN_EXPS if e in L]
        gan_grp = {}
        for frac in GAN_FRACTIONS:
            tag = f"g{int(frac * 100)}"
            gan_grp.update(cfg("{}_" + tag, g, 1, gan=frac, order="f"))
            gan_grp.update(cfg("{}_R_" + tag, g, 1, gan=frac, order="r"))
        groups["gan"] = gan_grp
    return groups


class Experiment:
    """Supervises uncertainty-thresholding experiments (experiment.py:49)."""

    def __init__(
        self,
        train_project,
        eval_projects=None,
        outcome: str = "cohort",
        outcome1: str = "LUAD",
        outcome2: str = "LUSC",
        outdir: str = "results",
    ):
        if eval_projects is None:
            eval_projects = []
        if isinstance(train_project, str):
            self.train_project = Project(train_project)
        elif isinstance(train_project, Project):
            self.train_project = train_project
        else:
            raise ValueError(
                f"Unrecognized value for train_project: {train_project}"
            )
        self.eval_projects = []
        for ep in eval_projects:
            if isinstance(ep, str):
                self.eval_projects.append(Project(ep))
            elif isinstance(ep, Project):
                self.eval_projects.append(ep)
            else:
                raise ValueError(
                    f"Unrecognized value for eval_project: {eval_projects}"
                )
        self.outcome = outcome
        self.outcome1 = outcome1
        self.outcome2 = outcome2
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        # Passed on to every training (train_project's keywords: device,
        # seed, fuse_blocks, max_tiles, ...); not in the reference.
        self.train_kwargs: Dict = {}

    # ------------------------------------------------------------------
    # Annotation-subset construction
    # ------------------------------------------------------------------

    def add(self, path, label, out1, out2, order="f", order_col="order",
            gan=0):
        """Write an ``include_{label}`` column selecting out1+out2 slides
        (+ GAN fraction) into the annotations file (experiment.py:85-145;
        implemented as an instance method per SURVEY.md §2.2.1)."""
        assert isinstance(out1, int)
        assert isinstance(out2, int)
        assert isinstance(gan, (int, float)) and 0 <= gan < 1
        assert order in ("f", "r")

        ann = pd.read_csv(path, dtype=str)
        log.info(f"Setting up exp. {label} with order {order} "
                 f"(sort by {order_col})")
        if order_col not in ann.columns:
            ann[order_col] = np.arange(len(ann))
        if "gan" not in ann.columns:
            ann["gan"] = "0"
        if "site" not in ann.columns:
            ann["site"] = "?"
        ann[order_col] = pd.to_numeric(ann[order_col])
        ann.sort_values(
            ["gan", self.outcome, order_col],
            ascending=[True, True, order != "r"],
            inplace=True,
        )
        gan_out1 = round(gan * out1)
        gan_out2 = round(gan * out2)
        site = ann["site"].to_numpy()
        out1_idx = np.where(
            (site != "GAN") & (ann[self.outcome] == self.outcome1)
        )[0]
        out2_idx = np.where(
            (site != "GAN") & (ann[self.outcome] == self.outcome2)
        )[0]
        gan1_idx = np.where(
            (site == "GAN") & (ann[self.outcome] == self.outcome1)
        )[0]
        gan2_idx = np.where(
            (site == "GAN") & (ann[self.outcome] == self.outcome2)
        )[0]

        assert out1 <= out1_idx.shape[0], f"not enough {self.outcome1} slides"
        assert out2 <= out2_idx.shape[0], f"not enough {self.outcome2} slides"
        assert gan_out1 <= gan1_idx.shape[0]
        assert gan_out2 <= gan2_idx.shape[0]

        include = np.array(["exclude"] * len(ann), dtype=object)
        include[out1_idx[:out1]] = "include"
        include[out2_idx[:out2]] = "include"
        include[gan1_idx[:gan_out1]] = "include"
        include[gan2_idx[:gan_out2]] = "include"
        ann[f"include_{label}"] = include
        ann.to_csv(path, index=False)

    # ------------------------------------------------------------------
    # Experiment-matrix construction
    # ------------------------------------------------------------------

    @staticmethod
    def config(name_pattern, subset, ratio=1, **kwargs):
        """Build {label: {out1, out2, **kwargs}} for a subset of the ladder
        with a class ratio (experiment.py:147-184). ratio != 1 creates the
        forward and inverse ('i'-suffixed) orderings."""
        if not isinstance(ratio, (int, float)) or ratio < 1:
            raise ValueError("Invalid ratio; must be number >= 1")
        config = {}
        for exp in ALL_EXP:
            if exp not in subset:
                continue
            if exp == "AA" and ratio != 1:
                raise ValueError(
                    "Cannot create full dataset exp. with ratio != 1"
                )
            exp_name = name_pattern.format(exp)
            if ratio != 1:
                n1 = round(ALL_EXP[exp] / (1 + (1 / ratio)))
                n2 = ALL_EXP[exp] - n1
                config[exp_name] = {"out1": n1, "out2": n2, **kwargs}
                config[exp_name + "i"] = {"out1": n2, "out2": n1, **kwargs}
            else:
                if ALL_EXP[exp] == "full":
                    n_out1, n_out2 = 467, 474
                else:
                    n_out1 = n_out2 = int(ALL_EXP[exp] / 2)
                config[exp_name] = {"out1": n_out1, "out2": n_out2, **kwargs}
        return config

    # ------------------------------------------------------------------
    # Training drivers
    # ------------------------------------------------------------------

    def train(self, hp, label, filters=None, save_predictions="csv",
              validate_on_batch=32, validation_steps=32, **kwargs):
        """Train one experiment label (experiment.py:1028-1051); under a
        multi-process runtime without ``n_submeshes``, in lockstep over
        the processes."""
        from .parallel import distributed as dist

        merged = dict(self.train_kwargs)
        merged.update(kwargs)
        # Read by run(), not by the trainer.
        scheduled = merged.pop("n_submeshes", None) is not None
        if dist.process_count() > 1 and not scheduled and (
                merged.get("mesh") is None):
            # One model trained in lockstep by every process, each on its
            # own devices (train_kwargs["device"] where that is given).
            from .parallel.mesh import Mesh, local_devices

            device = merged.get("device")
            merged["mesh"] = Mesh(
                local_devices() if device is None else [device],
                spans_processes=True)
        # train_kwargs may override the named defaults (passing e.g.
        # {'validate_on_batch': 2} must not collide with the explicit
        # keyword below).
        save_predictions = merged.pop("save_predictions", save_predictions)
        validate_on_batch = merged.pop("validate_on_batch",
                                       validate_on_batch)
        validation_steps = merged.pop("validation_steps", validation_steps)
        return self.train_project.train(
            self.outcome,
            exp_label=label,
            filters=filters,
            params=hp,
            save_predictions=save_predictions,
            validate_on_batch=validate_on_batch,
            validation_steps=validation_steps,
            **merged,
        )

    def train_nested_cv(self, hp, label, outer_k=3, inner_k=5,
                        scheduler=None, claim=None, collect=None, **kwargs):
        """Nested cross-validation: for each outer fold's training slides,
        run an inner k-fold (experiment.py:1053-1090); idempotent.

        With a ``parallel.scheduler.SubmeshScheduler``, each (outer,
        inner) fold is an independent task on its own submesh; inner
        folds share nothing but the lock-guarded splits JSON. ``claim``
        (a callable) keeps the tasks this process owns under distributed
        fold scheduling; with ``collect`` (a list) the tasks are appended
        to it instead of run, so that ``run`` dispatches step 4 of every
        size with one status exchange."""
        k_models = utils.find_cv(
            self.train_project, label, k=outer_k, outcome=self.outcome
        )
        tasks = []
        for ki, k_model in enumerate(k_models):
            inner_to_run = [
                k for k in range(1, inner_k + 1)
                if not utils.model_exists(
                    self.train_project, f"{label}-k{ki + 1}",
                    outcome=self.outcome, kfold=k,
                )
            ]
            if not inner_to_run:
                log.info(
                    f"Skipping nested cross-val k{ki + 1} for {label}; done."
                )
                continue
            if inner_to_run != list(range(1, inner_k + 1)):
                log.info(
                    f"Running k-folds {inner_to_run} for nested cross-val "
                    f"k{ki + 1} in {label}"
                )
            train_slides = utils.get_slides_from_model_manifest(
                k_model, dataset="training"
            )
            if scheduler is None:
                self.train(
                    hp=hp,
                    label=f"{label}-k{ki + 1}",
                    filters={"slide": train_slides},
                    val_k_fold=inner_k,
                    val_k=inner_to_run,
                    save_model=False,
                    **kwargs,
                )
                continue
            for k in inner_to_run:
                if claim is not None and not claim(f"{label}-k{ki + 1}_k{k}"):
                    continue  # a peer process owns this inner fold
                tasks.append(
                    lambda mesh, hp=hp.copy(), ki=ki, k=k, ts=train_slides,
                    kw=dict(kwargs): self.train(
                        hp=hp, label=f"{label}-k{ki + 1}",
                        filters={"slide": ts}, val_k_fold=inner_k,
                        val_k=[k], save_model=False, mesh=mesh, **kw,
                    )
                )
        if collect is not None:
            collect.extend(tasks)
        elif scheduler is not None and tasks:
            for r in scheduler.run(tasks):
                if isinstance(r, Exception):
                    raise r

    # ------------------------------------------------------------------
    # The 6-step protocol
    # ------------------------------------------------------------------

    def run(self, exp_to_run, steps=None, hp="nature2022"):
        """Run the published 6-step protocol (experiment.py:753-922).

        Steps: 1 full-epoch sweep (AA/A/D/G at epochs [1,3,5,10]);
        2 remaining sizes at epoch 1; 3 same with UQ; 4 nested UQ CV;
        5 FULL models (val none, early-stop step budget); 6 external eval.
        Step 6 passes ``train_kwargs``' ``max_tiles``, ``device`` and
        ``fuse_blocks`` on to ``Project.evaluate``. ``n_submeshes`` in
        ``train_kwargs`` schedules the folds (see the module docstring).
        """
        print(bold("Initializing experiments..."))
        from .parallel import distributed as dist

        P = self.train_project
        # Under a multi-process runtime, n_submeshes means N submeshes
        # over THIS process's devices, with (experiment, fold) tasks
        # claimed across all processes and trained independently on the
        # shared artifact tree.
        multiproc = dist.process_count() > 1
        distribute = multiproc and "n_submeshes" in self.train_kwargs
        # Without n_submeshes, each training is one model trained in
        # lockstep by every process (``train``).
        # Step barriers must outlive the longest peer's step: real ladder
        # steps run for hours.
        barrier_ms = int(os.environ.get(
            "BISCUIT_STEP_BARRIER_MS", 48 * 3600 * 1000))
        exp_annotations = join(P.root, "experiments.csv")
        if not multiproc or dist.is_main():
            if not exists(exp_annotations):
                shutil.copy(P.annotations, exp_annotations)
            existing_cols = pd.read_csv(
                exp_annotations, nrows=0).columns.tolist()
            for exp in exp_to_run:
                if f"include_{exp}" not in existing_cols:
                    self.add(exp_annotations, label=exp, **exp_to_run[exp])
        if multiproc:
            # Peers wait for main's annotation writes before reading them.
            dist.barrier("exp_annotations", barrier_ms)
        P.annotations = exp_annotations

        full_epoch_exp = [e for e in exp_to_run if e in FULL_EPOCH_EXPS]
        exp_hp = (
            biscuit_hp.nature2022_params() if hp == "nature2022" else hp.copy()
        )
        if steps is None:
            steps = range(7)

        def _fold_complete(label, kfold):
            """A fold counts as done only when its results_log.csv exists —
            a crashed run leaves the dir without it, and the trainer's
            incomplete-dir reuse + in-run checkpoints resume it."""
            if not utils.model_exists(P, label, outcome=self.outcome,
                                      kfold=kfold):
                return False
            d = utils.find_model(P, label, outcome=self.outcome, kfold=kfold)
            return exists(join(d, "results_log.csv"))

        def _pending_folds(label):
            return [
                k for k in range(1, 4) if not _fold_complete(label, k)
            ]

        # Experiment-level parallelism: with train_kwargs={'n_submeshes':
        # N}, the independent (experiment, fold) trainings of a step run
        # on N disjoint device groups (parallel/scheduler.py). Without it
        # (N <= 1, one process) the reference's sequential order holds.
        n_submeshes = self.train_kwargs.get("n_submeshes", 1) or 1
        scheduler = None
        claim_ns = None
        if distribute or n_submeshes > 1:
            import uuid

            from .parallel.mesh import local_devices
            from .parallel.scheduler import SubmeshScheduler

            device = self.train_kwargs.get("device")
            devices = (local_devices() if device is None
                       else [device] * n_submeshes)
            scheduler = SubmeshScheduler(n_submeshes=n_submeshes,
                                         devices=devices)
            if distribute:
                # Claim tokens are namespaced per run() call: the store's
                # counters live as long as the runtime, and a claim from
                # an earlier call must not mask a fold still to train
                # (completed folds are skipped by _fold_complete).
                claim_ns = dist.broadcast_from_main(
                    "exp_run_nonce",
                    uuid.uuid4().hex[:12] if dist.is_main() else None,
                    timeout_ms=barrier_ms)

        def _claim(token):
            """True when this process owns the task (always, alone)."""
            return claim_ns is None or dist.try_claim(f"{claim_ns}_{token}")

        def _dispatch(step_num, tasks):
            """Run scheduler tasks and re-raise the first failure, as the
            sequential order would. Distributed: every process meets at
            the step boundary and learns whether any peer failed, so no
            later step reads a half-written one."""
            err = None
            if tasks:
                for r in scheduler.run(tasks):
                    if isinstance(r, Exception):
                        err = err or r
            if distribute:
                all_ok = dist.exchange_ok(
                    f"{claim_ns}_step{step_num}", err is None, barrier_ms)
                if err is None and not all_ok:
                    raise RuntimeError(
                        f"a peer process failed step {step_num} "
                        "(distributed fold scheduling)")
            if err is not None:
                raise err

        def _cv_step(step_num, exps, uq):
            tasks = []
            for exp in exps:
                label = f"EXP_{exp}_UQ" if uq else f"EXP_{exp}"
                val_k = _pending_folds(label)
                if not val_k:
                    print(f"Skipping Step {step_num} for experiment {exp}; "
                          "already done.")
                    continue
                if val_k != [1, 2, 3]:
                    print(f"[Step {step_num}] Some k-folds done; running "
                          f"{val_k} for {exp}")
                kwargs = dict(
                    label=label, filters={f"include_{exp}": ["include"]},
                    splits=f"splits_{exp}.json", val_strategy="k-fold",
                    save_model=False,
                )
                if scheduler is None:
                    self.train(hp=exp_hp, val_k=val_k, **kwargs)
                    continue
                for k in val_k:
                    if not _claim(f"{label}_k{k}"):
                        continue  # a peer process owns this fold
                    tasks.append(
                        lambda mesh, hp=exp_hp.copy(), k=k, kw=kwargs:
                        self.train(hp=hp, val_k=[k], mesh=mesh, **kw)
                    )
            if scheduler is not None:
                _dispatch(step_num, tasks)

        if 1 in steps:
            print(bold("[Step 1] Running full-epoch experiments..."))
            exp_hp.epochs = [1, 3, 5, 10]
            exp_hp.uq = False
            _cv_step(1, full_epoch_exp, uq=False)

        if 2 in steps:
            print(bold("[Step 2] Running experiments at target epoch..."))
            exp_hp.epochs = [1]
            exp_hp.uq = False
            _cv_step(2, [e for e in exp_to_run if e not in full_epoch_exp],
                     uq=False)

        if 3 in steps:
            print(bold("[Step 3] Running experiments with UQ..."))
            exp_hp.epochs = [1]
            exp_hp.uq = True
            _cv_step(3, list(exp_to_run), uq=True)

        if 4 in steps:
            print(bold("[Step 4] Running nested UQ experiments..."))
            exp_hp.epochs = [1]
            exp_hp.uq = True
            step4_tasks = [] if distribute else None
            for exp in exp_to_run:
                total = exp_to_run[exp]["out1"] + exp_to_run[exp]["out2"]
                if total >= 50:
                    self.train_nested_cv(
                        hp=exp_hp,
                        label=f"EXP_{exp}_UQ",
                        val_strategy="k-fold",
                        splits=f"splits_{exp}_nested.json",
                        scheduler=scheduler,
                        claim=_claim if distribute else None,
                        collect=step4_tasks,
                    )
                else:
                    print(f"[Step 4] Skipping UQ for {exp}, need >=50 slides")
            if distribute:
                _dispatch(4, step4_tasks)

        if 5 in steps:
            print(bold("[Step 5] Training across full datasets..."))
            exp_hp.epochs = [1]
            exp_hp.uq = True
            full_tasks = []
            for exp in exp_to_run:
                if _fold_complete(f"EXP_{exp}_FULL", None):
                    print(f"Skipping Step 5 for experiment {exp}; "
                          "already done.")
                    continue
                try:
                    stop_batch = utils.find_cv_early_stop(
                        P, f"EXP_{exp}", outcome=self.outcome, k=3
                    )
                except (MatchError, FileNotFoundError):
                    stop_batch = None
                print(f"Using detected early stop batch {stop_batch}")
                kwargs = dict(
                    label=f"EXP_{exp}_FULL",
                    filters={f"include_{exp}": ["include"]},
                    save_model=True, val_strategy="none",
                    steps_per_epoch_override=stop_batch,
                )
                if scheduler is None:
                    self.train(hp=exp_hp, **kwargs)
                    continue
                if not _claim(f"EXP_{exp}_FULL"):
                    continue  # a peer process owns this FULL model
                full_tasks.append(
                    lambda mesh, hp=exp_hp.copy(), kw=kwargs:
                    self.train(hp=hp, mesh=mesh, **kw)
                )
            if scheduler is not None:
                _dispatch(5, full_tasks)

        if 6 in steps:
            # Distributed: evaluations are claimed per (eval project,
            # experiment) and run in the claiming process alone
            # (collective=False); one status exchange closes the step.
            eval_kwargs = {k: v for k, v in self.train_kwargs.items()
                           if k in ("max_tiles", "device", "fuse_blocks")}
            if distribute:
                eval_kwargs["collective"] = False
            step6_err = None
            for val_P in self.eval_projects:
                print(bold(f"[Step 6] Running eval ({val_P.name})..."))
                for exp in exp_to_run:
                    if distribute and not _claim(f"eval_{val_P.name}_{exp}"):
                        continue  # a peer process owns this evaluation
                    try:
                        full_model = utils.find_model(
                            P, f"EXP_{exp}_FULL", outcome=self.outcome,
                            epoch=1,
                        )
                        if utils.eval_exists(
                            val_P, f"EXP_{exp}_FULL", outcome=self.outcome,
                            epoch=1,
                        ):
                            print(f"Skipping eval for experiment {exp}; "
                                  "already done.")
                            continue
                        val_P.evaluate(
                            full_model,
                            self.outcome,
                            filters={
                                self.outcome: [self.outcome1, self.outcome2]
                            },
                            save_predictions=True,
                            **eval_kwargs,
                        )
                    except Exception as e:
                        if not distribute:
                            raise
                        step6_err = step6_err or e
                        log.error(f"[Step 6] eval {exp} failed: {e}")
            if distribute:
                all_ok = dist.exchange_ok(
                    f"{claim_ns}_step6", step6_err is None, barrier_ms)
                if step6_err is not None:
                    raise step6_err
                if not all_ok:
                    raise RuntimeError(
                        "a peer process failed step 6 "
                        "(distributed fold scheduling)")

    # ------------------------------------------------------------------
    # Nested-CV threshold derivation
    # ------------------------------------------------------------------

    def thresholds_from_nested_cv(
        self, label, outer_k=3, inner_k=5, id=None, threshold_params=None,
        epoch=1, tile_filename="tile_predictions_val_epoch1.csv",
        y_true=None, y_pred=None, uncertainty=None,
    ):
        """Derive tile/slide UQ + slide prediction thresholds from nested CV
        (experiment.py:924-1026): per outer fold, thresholds come from the
        inner 5-fold predictions (tile_uq first with slide_uq disabled, then
        slide thresholds at the fixed tile_uq — call stack SURVEY.md §3.2);
        outer-fold tile predictions validate them; final thresholds are the
        across-fold means."""
        if id is None:
            id = label
        patients = self.train_project.dataset(
            verification=None
        ).patients()
        if threshold_params is None:
            threshold_params = {
                "tile_pred": "detect",
                "slide_pred": "detect",
                "plot": False,
                "patients": patients,
            }
        # The device statistics backend runs where the trainings do.
        threshold_params = {"device": self.train_kwargs.get("device"),
                            **threshold_params}
        all_tile_uq, all_slide_uq, all_slide_pred = [], [], []
        df = pd.DataFrame()
        for k in range(1, outer_k + 1):
            try:
                dfs = utils.df_from_cv(
                    self.train_project, f"{label}-k{k}",
                    outcome=self.outcome, k=inner_k,
                    y_true=y_true, y_pred=y_pred, uncertainty=uncertainty,
                )
            except (ModelNotFoundError, OSError):
                log.warning(f"Could not find {label} k-fold {k}; skipping")
                continue
            val_path = join(
                utils.find_model(
                    self.train_project, label, kfold=k, outcome=self.outcome
                ),
                tile_filename,
            )
            if not exists(val_path):
                log.warning(f"Could not find {label} k-fold {k}; skipping")
                continue
            tile_uq = threshold.from_cv(
                dfs, tile_uq="detect", slide_uq=None, **threshold_params
            )["tile_uq"]
            thresholds = threshold.from_cv(
                dfs, tile_uq=tile_uq, slide_uq="detect", **threshold_params
            )
            all_tile_uq.append(tile_uq)
            all_slide_uq.append(thresholds["slide_uq"])
            all_slide_pred.append(thresholds["slide_pred"])

            tile_pred_df = pd.read_csv(val_path, dtype={"slide": str})
            utils.rename_cols(
                tile_pred_df, self.outcome,
                y_true=y_true, y_pred=y_pred, uncertainty=uncertainty,
            )

            def uq_auc_by_level(level):
                results, _ = threshold.apply(
                    tile_pred_df.copy(), plot=False, patients=patients,
                    level=level, device=threshold_params["device"],
                    **thresholds,
                )
                return results["auc"], results["percent_incl"]

            pt_auc, pt_perc = uq_auc_by_level("patient")
            slide_auc, slide_perc = uq_auc_by_level("slide")
            model = utils.find_model(
                self.train_project, label, kfold=k, epoch=epoch,
                outcome=self.outcome,
            )
            m_slides = utils.get_slides_from_model_manifest(
                model, dataset=None
            )
            df = pd.concat(
                [df, pd.DataFrame([{
                    "id": id,
                    "n_slides": len(m_slides),
                    "fold": k,
                    "uq": "include",
                    "patient_auc": pt_auc,
                    "patient_uq_perc": pt_perc,
                    "slide_auc": slide_auc,
                    "slide_uq_perc": slide_perc,
                }])],
                axis=0, join="outer", ignore_index=True,
            )

        thresholds = {
            "tile_uq": None if not all_tile_uq else mean(all_tile_uq),
            "slide_uq": None if not all_slide_uq else mean(all_slide_uq),
            "slide_pred": None if not all_slide_pred else mean(all_slide_pred),
        }
        return df, thresholds

    # ------------------------------------------------------------------
    # Results assembly
    # ------------------------------------------------------------------

    def results(self, exp_to_run, uq=True, eval=True, plot=False):
        """Assemble cross-val + external-eval metrics with UQ thresholding
        (experiment.py:488-751). Returns (cv DataFrame, {eval_name: df})."""
        P = self.train_project
        df = pd.DataFrame()
        eval_dfs = {p.name: pd.DataFrame() for p in self.eval_projects}
        prediction_thresholds = {}
        tile_uq_thresholds = {}
        slide_uq_thresholds = {}
        pred_uq_thresholds = {}

        # --- cross-val results at epoch 1 (non-UQ arm) ---------------------
        for exp in exp_to_run:
            try:
                models = utils.find_cv(P, f"EXP_{exp}", outcome=self.outcome)
            except MatchError:
                log.debug(f"No cross-val results for {exp}; skipping")
                continue
            for i, m in enumerate(models):
                try:
                    res = utils.get_model_results(
                        m, outcome=self.outcome, epoch=1
                    )
                except (FileNotFoundError, ModelNotFoundError):
                    log.debug(f"Unable to open cross-val results for {exp}")
                    continue
                n_slides = len(
                    utils.get_slides_from_model_manifest(m, dataset=None)
                )
                df = pd.concat(
                    [df, pd.DataFrame([{
                        "id": exp, "n_slides": n_slides, "fold": i + 1,
                        "uq": "none",
                        "patient_auc": res["pt_auc"],
                        "patient_ap": res["pt_ap"],
                        "slide_auc": res["slide_auc"],
                        "slide_ap": res["slide_ap"],
                        "tile_auc": res["tile_auc"],
                        "tile_ap": res["tile_ap"],
                    }])],
                    axis=0, join="outer", ignore_index=True,
                )

        # --- UQ cross-val (non-thresholded 'all' arm) ----------------------
        for exp in exp_to_run:
            try:
                models = utils.find_cv(
                    P, f"EXP_{exp}_UQ", outcome=self.outcome
                )
            except MatchError:
                continue
            all_pred_thresh = []
            skip = False
            for i, m in enumerate(models):
                try:
                    res = utils.get_model_results(
                        m, outcome=self.outcome, epoch=1
                    )
                    all_pred_thresh.append(res["opt_thresh"])
                    n_slides = len(
                        utils.get_slides_from_model_manifest(m, dataset=None)
                    )
                    df = pd.concat(
                        [df, pd.DataFrame([{
                            "id": exp, "n_slides": n_slides, "fold": i + 1,
                            "uq": "all",
                            "patient_auc": res["pt_auc"],
                            "patient_ap": res["pt_ap"],
                            "slide_auc": res["slide_auc"],
                            "slide_ap": res["slide_ap"],
                            "tile_auc": res["tile_auc"],
                            "tile_ap": res["tile_ap"],
                        }])],
                        axis=0, join="outer", ignore_index=True,
                    )
                except (FileNotFoundError, ModelNotFoundError):
                    log.debug(f"Skipping UQ crossval results for {exp}")
                    skip = True
                    break
            if not skip and all_pred_thresh and None not in all_pred_thresh:
                prediction_thresholds[exp] = mean(all_pred_thresh)

        # --- nested-UQ thresholds + thresholded cross-val arm --------------
        if uq:
            for exp in exp_to_run:
                if exp in NO_UQ_EXPS:
                    continue
                try:
                    _df, thresh = self.thresholds_from_nested_cv(
                        f"EXP_{exp}_UQ", id=exp
                    )
                    if thresh["tile_uq"] is None:
                        raise ThresholdError("no thresholds detected")
                    df = pd.concat([df, _df], axis=0, join="outer",
                                   ignore_index=True)
                except (MatchError, FileNotFoundError,
                        ModelNotFoundError) as e:
                    log.debug(f"Skipping UQ crossval results for {exp}: {e}")
                    continue
                except ThresholdError as e:
                    log.debug(
                        f"Skipping UQ crossval results for {exp}; could not "
                        f"find thresholds in cross-validation: {e}"
                    )
                    continue
                tile_uq_thresholds[exp] = thresh["tile_uq"]
                slide_uq_thresholds[exp] = thresh["slide_uq"]
                pred_uq_thresholds[exp] = thresh["slide_pred"]
                if plot and exp == "AA":
                    self.plot_uq_calibration(label=f"EXP_{exp}_UQ", **thresh)

        # --- external evaluation -------------------------------------------
        if eval:
            for val_P in self.eval_projects:
                name = val_P.name
                for exp in exp_to_run:
                    try:
                        eval_dir = utils.find_eval(
                            val_P, f"EXP_{exp}_FULL", outcome=self.outcome
                        )
                        res = utils.get_eval_results(
                            eval_dir, outcome=self.outcome
                        )
                    except (FileNotFoundError, MatchError):
                        log.debug(f"Skipping eval for exp {exp}; not found")
                        continue
                    if not utils.model_exists(
                        P, f"EXP_{exp}_FULL", outcome=self.outcome, epoch=1
                    ):
                        continue
                    pred_thresh = prediction_thresholds.get(exp, 0.5)
                    if exp not in prediction_thresholds:
                        log.warning(
                            f"No predictions threshold for experiment {exp};"
                            " using slide-level pred threshold of 0.5"
                        )

                    patient_yt, patient_yp = utils.read_group_predictions(
                        join(
                            eval_dir,
                            f"patient_predictions_{self.outcome}_eval.csv",
                        )
                    )
                    patient_metrics = {
                        f"patient_{k}": v
                        for k, v in utils.prediction_metrics(
                            patient_yt, patient_yp, threshold=pred_thresh
                        ).items()
                    }
                    # Deliberate fix of §2.2.6: use the slide-level file when
                    # available (reference reads the patient file twice).
                    slide_path = join(
                        eval_dir,
                        f"slide_predictions_{self.outcome}_eval.csv",
                    )
                    if exists(slide_path):
                        slide_yt, slide_yp = utils.read_group_predictions(
                            slide_path
                        )
                    else:
                        slide_yt, slide_yp = patient_yt, patient_yp
                    slide_metrics = {
                        f"slide_{k}": v
                        for k, v in utils.prediction_metrics(
                            slide_yt, slide_yp, threshold=pred_thresh
                        ).items()
                    }
                    model = utils.find_model(
                        P, f"EXP_{exp}_FULL", outcome=self.outcome, epoch=1
                    )
                    n_slides = len(
                        utils.get_slides_from_model_manifest(
                            model, dataset=None
                        )
                    )
                    eval_dfs[name] = pd.concat(
                        [eval_dfs[name], pd.DataFrame([{
                            "id": exp, "n_slides": n_slides, "uq": "none",
                            "incl": 1,
                            "patient_auc": res["pt_auc"],
                            "patient_ap": res["pt_ap"],
                            "slide_auc": res["slide_auc"],
                            "slide_ap": res["slide_ap"],
                            **patient_metrics, **slide_metrics,
                        }])],
                        axis=0, join="outer", ignore_index=True,
                    )

                    if exp not in prediction_thresholds:
                        continue

                    # --- UQ-thresholded eval arms -------------------------
                    if uq and exp in tile_uq_thresholds:
                        val_patients = val_P.dataset(
                            verification=None
                        ).patients()
                        for keep in ("high_confidence", "low_confidence"):
                            tile_pred_df = pd.read_csv(
                                join(eval_dir, "tile_predictions_eval.csv"),
                                dtype={"slide": str},
                            )
                            utils.rename_cols(tile_pred_df, self.outcome)

                            def by_level(level):
                                # Figure contract (experiment.py:705-722):
                                # only the slide-level, high-confidence, AA
                                # arm draws, and results() saves it as
                                # {name}_uncertainty_v_preds.svg.
                                return threshold.apply(
                                    tile_pred_df.copy(),
                                    tile_uq=tile_uq_thresholds[exp],
                                    slide_uq=slide_uq_thresholds[exp],
                                    tile_pred=0.5,
                                    slide_pred=pred_uq_thresholds[exp],
                                    plot=(plot and level == "slide"
                                          and keep == "high_confidence"
                                          and exp == "AA"),
                                    title=f"{name}: Exp. {exp} Uncertainty",
                                    keep=keep,
                                    patients=val_patients,
                                    level=level,
                                    device=self.train_kwargs.get("device"),
                                )

                            s_res, _ = by_level("slide")
                            p_res, _ = by_level("patient")
                            if (plot and keep == "high_confidence"
                                    and exp == "AA"):
                                import matplotlib.pyplot as plt

                                plt.savefig(join(
                                    self.outdir,
                                    f"{name}_uncertainty_v_preds.svg",
                                ))
                                plt.close("all")
                            if s_res["auc"] is None or p_res["auc"] is None:
                                continue
                            eval_dfs[name] = pd.concat(
                                [eval_dfs[name], pd.DataFrame([{
                                    "id": exp,
                                    "n_slides": n_slides,
                                    "uq": ("include"
                                           if keep == "high_confidence"
                                           else "exclude"),
                                    "slide_incl": s_res["percent_incl"],
                                    "slide_auc": s_res["auc"],
                                    "slide_acc": s_res["acc"],
                                    "slide_sens": s_res["sensitivity"],
                                    "slide_spec": s_res["specificity"],
                                    "slide_youden": (
                                        s_res["sensitivity"]
                                        + s_res["specificity"] - 1
                                    ),
                                    "patient_incl": p_res["percent_incl"],
                                    "patient_auc": p_res["auc"],
                                    "patient_acc": p_res["acc"],
                                    "patient_sens": p_res["sensitivity"],
                                    "patient_spec": p_res["specificity"],
                                    "patient_youden": (
                                        p_res["sensitivity"]
                                        + p_res["specificity"] - 1
                                    ),
                                }])],
                                axis=0, join="outer", ignore_index=True,
                            )
            for eval_name in eval_dfs:
                eval_dfs[eval_name].to_csv(
                    join(self.outdir, f"{eval_name}_results.csv"), index=False
                )
        else:
            eval_dfs = None
        df.to_csv(join(self.outdir, "crossval_results.csv"), index=False)
        return df, eval_dfs

    # ------------------------------------------------------------------
    # Figures
    # ------------------------------------------------------------------

    def plot_uq_calibration(self, label, tile_uq, slide_uq, slide_pred,
                            epoch=1, k=3):
        """Tile- and slide-level predictions-vs-uncertainty calibration plots
        from the CV predictions (experiment.py:437-486).

        Deliberate fixes: the reference draws both figures and neither saves
        nor closes them (they only persist if a later caller happens to
        savefig, experiment.py:722) — we save each to
        ``{label}_{kind}_uncertainty_v_preds.svg`` under ``self.outdir`` and
        close them (VERDICT r1 missing-item 4); and the reference hardcodes
        the 3-fold CV (``range(1, 4)``, experiment.py:457) — ``k`` keeps
        that default but follows non-default fold counts."""
        val_dfs = [
            pd.read_csv(
                join(
                    utils.find_model(
                        self.train_project, label, kfold=ki,
                        outcome=self.outcome,
                    ),
                    f"tile_predictions_val_epoch{epoch}.csv",
                ),
                dtype={"slide": str},
            )
            for ki in range(1, k + 1)
        ]
        for v in val_dfs:
            utils.rename_cols(v, outcome=self.outcome)
        _df = pd.concat(val_dfs, axis=0, join="outer", ignore_index=True)

        import matplotlib.pyplot as plt

        patients = self.train_project.dataset().patients()
        _df, _ = threshold.process_tile_predictions(_df, patients=patients)
        threshold.plot_uncertainty(
            _df, kind="tile", threshold=tile_uq,
            title=f"CV UQ Calibration: {label}",
        )
        plt.savefig(join(self.outdir, f"{label}_tile_uncertainty_v_preds.svg"))
        plt.close()
        _df = _df[_df["uncertainty"] < tile_uq]
        _s_df, _ = threshold.process_group_predictions(
            _df, pred_thresh=slide_pred, level="slide"
        )
        threshold.plot_uncertainty(
            _s_df, kind="slide", threshold=slide_uq,
            title=f"CV UQ Calibration: {label}",
        )
        plt.savefig(join(self.outdir, f"{label}_slide_uncertainty_v_preds.svg"))
        plt.close()

    def display(self, df, eval_dfs, hue="uq", palette="tab10",
                relplot_uq_compare=True, boxplot_uq_compare=True,
                ttest_uq_groups=("all", "include"), prefix=""):
        """Cross-val + eval figures and paired t-tests
        (experiment.py:186-435). Writes SVGs into self.outdir."""
        import matplotlib.pyplot as plt
        import matplotlib.ticker as plticker
        import seaborn as sns
        from scipy import stats

        from .threshold import _loess_smooth

        if not len(df):
            log.error("No results to display")
            return

        df = df.loc[
            ~((df["n_slides"] < 100) & df["uq"].isin(["include", "exclude"]))
        ]

        # --- paired t-tests -------------------------------------------------
        if ttest_uq_groups and len(ttest_uq_groups) != 2:
            raise ValueError("Length of ttest_uq_groups must be exactly 2")
        if ttest_uq_groups:
            tt = df.loc[df["uq"].isin(ttest_uq_groups)].copy()
            tt = tt.sort_values(["id", "fold"])
            for level in ("patient", "slide"):
                print(f"Paired t-tests ({level}-level):")
                for n in sorted(tt["n_slides"].unique()):
                    sub = tt[tt["n_slides"] == n]
                    a = sub.loc[sub["uq"] == ttest_uq_groups[0]][
                        f"{level}_auc"]
                    b = sub.loc[sub["uq"] == ttest_uq_groups[1]][
                        f"{level}_auc"]
                    try:
                        t = stats.ttest_rel(a, b, alternative="less")
                        print(n, "\t", "p =", t.pvalue)
                    except (ValueError, AttributeError):
                        # The reference catches ValueError here
                        # (experiment.py:236, 303: "p = (error)" for
                        # degenerate groups); the scipy in this image
                        # raises AttributeError from its axis-nan-policy
                        # wrapper for size-0 inputs instead ('float' has
                        # no 'dtype') — same degenerate condition, so it
                        # gets the same "(error)" row. Shaken out by the
                        # full-matrix sitting: ladder sizes whose UQ rows
                        # were all skipped produce empty t-test groups.
                        print(n, "\t", "p = (error)")

        # --- cross-validation plots -----------------------------------------
        rel_df = df.loc[df["uq"] != "none"] if relplot_uq_compare else df
        if len(rel_df):
            sns.relplot(
                x="n_slides", y="slide_auc", data=rel_df, hue=hue,
                marker="o", kind="line", palette=palette,
            )
            plt.title("Cross-val AUC")
            ax = plt.gca()
            ax.set_ylim([0.5, 1])
            ax.grid(visible=True, which="both", axis="both", color="white")
            ax.set_facecolor("#EAEAF2")
            ax.xaxis.set_minor_locator(plticker.MultipleLocator(100))
            plt.subplots_adjust(top=0.9)
            plt.savefig(join(self.outdir, f"{prefix}relplot.svg"))
            plt.close()

        f, axes = plt.subplots(1, 3)
        f.set_size_inches(18, 6)
        box_df = df.loc[df["uq"] != "none"] if boxplot_uq_compare else df
        if len(box_df):
            sns.boxplot(
                x="n_slides", y="slide_auc", hue=hue, data=box_df,
                ax=axes[0], palette=palette,
            )
        axes[0].title.set_text("Cross-val AUC")
        axes[0].set_ylabel("")
        axes[0].tick_params(labelrotation=90)

        df = df.sort_values(by=["n_slides"])
        x = df["n_slides"].to_numpy().astype(np.float32)
        # Coerce: at full-grid scale slide_auc can arrive as an object
        # column (None for experiments whose UQ thresholds were
        # undetectable); np.isfinite on an object array raises TypeError.
        # None -> NaN keeps those rows out of the LOESS panel, same as the
        # reference's NaN rows. Shaken out by the full-matrix sitting.
        y = pd.to_numeric(df["slide_auc"], errors="coerce").to_numpy(
            np.float64)
        finite = np.isfinite(y)
        if finite.sum() > 3:
            z, se = _loess_smooth(x[finite], y[finite])
            axes[1].plot(x[finite], y[finite], "+", ms=6)
            axes[1].plot(x[finite], z)
            axes[1].fill_between(
                x[finite], z - 1.96 * se, z + 1.96 * se, alpha=0.33
            )
        axes[1].xaxis.set_minor_locator(plticker.MultipleLocator(20))
        axes[1].grid(visible=True, which="both", axis="both", color="white")
        axes[1].set_facecolor("#EAEAF2")
        axes[1].set_xscale("log")
        axes[1].title.set_text("Cross-val AUC")

        if "patient_uq_perc" in df.columns and df["patient_uq_perc"].notna().any():
            sns.lineplot(
                x="n_slides", y="patient_uq_perc", data=df, marker="o",
                ax=axes[2], zorder=3,
            )
        axes[2].set_ylabel("")
        axes[2].title.set_text("% Patients Included with UQ (cross-val)")
        axes[2].tick_params(labelrotation=90)
        axes[2].set_facecolor("#EAEAF2")
        plt.subplots_adjust(bottom=0.2)
        plt.savefig(join(self.outdir, f"{prefix}crossval.svg"))
        plt.close()

        # --- evaluation plots -------------------------------------------------
        if eval_dfs:
            for eval_name, eval_df in eval_dfs.items():
                if not len(eval_df):
                    continue
                eval_df = eval_df.loc[
                    ~((eval_df["n_slides"] < 100)
                      & eval_df["uq"].isin(["include", "exclude"]))
                ]
                has_uq = len(
                    eval_df.loc[eval_df["uq"].isin(["include", "exclude"])]
                )
                sns.set(rc={"xtick.bottom": True, "ytick.left": True})
                f, axes = plt.subplots(1, (4 if has_uq else 3))
                f.suptitle(f"{eval_name} Evaluation Dataset")
                f.set_size_inches(16, 4)
                for i, metric in enumerate(("auc", "acc", "youden")):
                    pcol, scol = f"patient_{metric}", f"slide_{metric}"
                    if pcol in eval_df.columns:
                        sns.lineplot(
                            x="n_slides", y=pcol, hue="uq", data=eval_df,
                            marker="o", ax=axes[i],
                        )
                    if scol in eval_df.columns:
                        sns.scatterplot(
                            x="n_slides", y=scol, hue="uq", data=eval_df,
                            marker="x", ax=axes[i],
                        )
                    if axes[i].get_legend():
                        axes[i].get_legend().remove()
                    axes[i].title.set_text(metric.upper())
                if has_uq:
                    inc = eval_df.loc[eval_df["uq"] == "include"]
                    sns.lineplot(
                        x="n_slides", y="patient_incl", data=inc,
                        marker="o", ax=axes[3],
                    )
                    sns.scatterplot(
                        x="n_slides", y="slide_incl", data=inc,
                        marker="x", ax=axes[3],
                    )
                    axes[3].title.set_text("% Included")
                for ax in axes:
                    ax.set_ylabel("")
                    ax.tick_params(labelrotation=90)
                plt.subplots_adjust(top=0.8, bottom=0.2)
                # Deliberate fix: the reference writes the same
                # f'{prefix}eval.svg' for every eval project
                # (experiment.py:435), so multi-eval runs silently overwrite
                # the figure. We key the filename by eval-project name.
                plt.savefig(join(self.outdir, f"{prefix}{eval_name}_eval.svg"))
                plt.close()
