"""Experiment-matrix training CLI.

Counterpart of ``biscuit_tpu/cli/train.py`` (reference train.py): runs
the published grid — regular experiments (forward/reverse x two
orderings), 3:1/10:1 class-ratio experiments on the 'AMDPGZ' subset, and
GAN-fraction experiments (10-50%) — via Experiment.run, with the same
``--steps`` range parser. ``--device`` says where every training and
evaluation runs (the card by default; ``cpu`` to run without one).
``--submeshes`` greater than 1 raises until the port's parallelism
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import click

from ..experiment import Experiment, published_matrix


def num_range(s: str):
    """Parse '1-6' or '1,3,5' or '4' into a list of ints (train.py:14-23)."""
    if "-" in s:
        lo, hi = s.split("-")
        return list(range(int(lo), int(hi) + 1))
    if "," in s:
        return [int(x) for x in s.split(",")]
    return [int(s)]


@click.command()
@click.option("--train_project", default="projects/training",
              help="Path to training project.")
@click.option("--eval_project", "eval_projects", multiple=True,
              default=("projects/evaluation",),
              help="Path(s) to evaluation project(s).")
@click.option("--outcome", default="cohort")
@click.option("--outcome1", default="LUAD")
@click.option("--outcome2", default="LUSC")
@click.option("--steps", default="1-6", help="Steps to run, e.g. 1-6 or 2,3.")
@click.option("--reg", default=True, type=bool,
              help="Run regular experiment matrix.")
@click.option("--ratio", default=True, type=bool,
              help="Run 3:1 and 10:1 class-ratio experiments.")
@click.option("--gan", default=False, type=bool,
              help="Run GAN-fraction experiments.")
@click.option("--subset", default=None,
              help="Comma-separated experiment IDs (default: full ladder).")
@click.option("--hp_json", default=None,
              help="JSON file overriding hyperparameters (ModelParams "
                   "fields); default is the published nature2022 config.")
@click.option("--orderings", default=True, type=bool,
              help="Include the reverse/order2 orderings of the reg matrix.")
@click.option("--submeshes", default=1, type=int,
              help="Train independent folds concurrently on N device "
                   "groups (not ported yet: only 1).")
@click.option("--device", default=None,
              help="Where to train and evaluate: the CUDA card by default, "
                   "or e.g. 'cpu'.")
def train_models(train_project, eval_projects, outcome, outcome1, outcome2,
                 steps, reg, ratio, gan, subset, hp_json, orderings,
                 submeshes, device):
    """Train the published experiment grid (train.py:27-96)."""
    experiment = Experiment(
        train_project,
        eval_projects=list(eval_projects),
        outcome=outcome,
        outcome1=outcome1,
        outcome2=outcome2,
    )
    if submeshes and submeshes > 1:
        experiment.train_kwargs["n_submeshes"] = submeshes
    if device is not None:
        experiment.train_kwargs["device"] = device
    hp = "nature2022"
    if hp_json:
        import json

        from ..hp import ModelParams, nature2022_params

        base = nature2022_params().to_dict()
        with open(hp_json) as f:
            base.update(json.load(f))
        hp = ModelParams.from_dict(base)
    step_list = num_range(steps)

    # The published grid (reference train.py:61-96), group by group in the
    # reference's training order (train.py:95-96).
    ladder = None if subset is None else subset.split(",")
    groups = published_matrix(ladder=ladder, reg=reg, orderings=orderings,
                              ratio=ratio, gan=gan)
    n_exps = sum(len(g) for g in groups.values())
    click.echo(f"Running {n_exps} experiments "
               f"({', '.join(groups)}), steps {step_list}")
    for group_name, group in groups.items():
        click.echo(f"== group {group_name}: {len(group)} experiments ==")
        experiment.run(group, steps=step_list, hp=hp)


if __name__ == "__main__":
    train_models()
