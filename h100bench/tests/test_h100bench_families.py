"""A trunk family is files only: a toy third family (``toy_family.py``),
written with its cells into a directory of the test's own, is found by the
harness's lookup, made into weights from its own roles, and driven through
``drive.execute``, serving and training, on the CPU; its runs are correct,
every fault it can have makes a run incorrect, and the fault it cannot
have (``frozen_stats``: no running statistics) is skipped and said so.
What a family, a role or a limit lacks is refused by name."""

import json
import time

import pytest
import torch

from h100bench import control
from h100bench.harness import check, drive, faults, spec, weights
from h100bench.reference import families
from h100bench.reference.params import param_specs, running_statistics
from h100bench.tests import tiny, toy

SEED = 2 ** 31 + 61


@pytest.fixture
def toy_cells(tmp_path, monkeypatch):
    """{entry: the toy cell}, with the toy model in ``build_model``'s
    place."""
    import biscuit_torch.models.xception as port_models

    monkeypatch.setattr(port_models, "build_model", toy.build_model)
    torch.set_num_threads(2)
    bench = toy.write(tmp_path)
    return {entry: spec.load_cell(name, base=tmp_path, bench=bench)
            for entry, name in toy.CELLS.items()}


def _run(cell, seed=SEED):
    return drive.execute(cell, seed, 0.3, False, torch.device("cpu"),
                         time.perf_counter())


def test_the_toy_family_is_found_under_the_cells_directory(toy_cells):
    cfg = toy_cells["train"].config
    fam = families.of(cfg)
    assert fam.__file__.startswith(cfg["bench_dir"])
    assert fam.port_arch("toy_tiny", toy.port) == cfg["arch"]
    assert families.of(spec.load_cell("resnet50.train.b128").config) is \
        families.lookup("resnet")


def test_toy_specs_are_the_stand_ins_state_dict(toy_cells):
    from biscuit_torch.hp import ModelParams

    cfg = toy_cells["train"].config
    model = toy.build_model(ModelParams.from_dict(cfg["hp"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = param_specs(cfg)
    assert {n: tuple(s) for n, s, _ in specs} == want
    assert running_statistics(specs) == []
    w = weights.make(cfg, SEED, "cpu")
    scale = w["backbone.norm.weight"]
    assert 0.8 <= float(scale.min()) and float(scale.max()) <= 1.2
    assert float(w["backbone.norm.bias"].abs().max()) > 0


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_toy_runs_are_correct(entry, toy_cells):
    c = toy_cells[entry]
    for seed in (SEED, 7):
        line, record = _run(c, seed)
        assert line["correct"], line["checks"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(record["readings"]) == check.givable(entry, c.config)
    assert "running_gap" not in record["readings"]


def _toy_faults():
    out = [("serve", f, None) for f in faults.FAULTS["serve"]]
    out += [("train", f, None) for f in faults.FAULTS["train"]
            if f not in ("scaled", "frozen_stats")]
    return out + [("train", "scaled", g) for g in toy.GROUPS]


@pytest.mark.parametrize("entry, fault, group", _toy_faults())
def test_each_toy_fault_makes_the_run_incorrect(entry, fault, group,
                                                toy_cells):
    c = toy_cells[entry]
    assert fault in faults.applicable(entry, c.config)
    prefixes = c.config["leaf_groups"][group] if group else ()
    with faults.planted(entry, fault, prefixes):
        line, _ = _run(c)
    assert not line["correct"], line["checks"]


def test_frozen_stats_is_skipped_and_said(toy_cells, capsys):
    c = toy_cells["train"]
    assert "frozen_stats" not in faults.applicable("train", c.config)
    planted = control.planted_faults(c)
    assert "frozen_stats" not in {f for _, f, _ in planted}
    assert {k for k, _, _ in planted} == {
        "half_batch", "altered", *(f"scaled.{g}" for g in toy.GROUPS)}
    assert "fault frozen_stats skipped" in capsys.readouterr().err
    real = spec.load_cell("resnet50.train.b128")
    assert "frozen_stats" in {f for _, f, _ in control.planted_faults(real)}


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_the_control_fails_the_toy_limits(entry, toy_cells):
    c = toy_cells[entry]
    ok, checks = check.judge(control.control_numbers(c, SEED, "cpu"),
                             c.limits)
    assert not ok, checks


def test_an_unknown_family_names_the_file_it_looked_for(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"no_such\.py"):
        families.lookup("no_such", tmp_path)
    bench, names = tiny.write(tmp_path, ("resnet50.serve.b256",))
    path = tmp_path / "configs" / "resnet50-nature2022-tiny-serve.json"
    cfg = json.loads(path.read_text())
    cfg["arch"]["family"] = "resnet_v9"
    path.write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match=r"families/resnet_v9\.py"):
        tiny.load(tmp_path, bench, names["resnet50.serve.b256"])


def test_an_unknown_weight_role_is_refused(toy_cells, tmp_path):
    fam = tmp_path / "reference" / "families"
    (fam / "toy_badrole.py").write_text((fam / "toy.py").read_text().replace(
        '(d,), "ln_bias")', '(d,), "ln_shift")'))
    cfg = dict(toy_cells["serve"].config)
    cfg["arch"] = dict(cfg["arch"], family="toy_badrole")
    with pytest.raises(ValueError, match=r"backbone\.norm\.bias.*'ln_shift'"):
        weights.make(cfg, SEED, "cpu")


def test_a_limit_the_model_cannot_give_is_refused(toy_cells, tmp_path):
    bench = toy.write(tmp_path)
    path = tmp_path / "workloads" / f"{toy.CELLS['train']}.json"
    w = json.loads(path.read_text())
    w["limits"]["running_gap"] = 0.01
    path.write_text(json.dumps(w))
    with pytest.raises(ValueError, match="running_gap"):
        spec.load_cell(toy.CELLS["train"], base=tmp_path, bench=bench)
    with pytest.raises(ValueError, match="running_gap"):
        check.judge({"change_gap": 0.0}, {"change_gap": 0.1,
                                          "running_gap": 0.01})
