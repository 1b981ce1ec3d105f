"""The harness finds every piece of a cell by name, and the manifest keeps
to the contract's shapes."""

import importlib
import json
import re

import pytest

from h100bench.harness import spec
from h100bench.reference import families
from h100bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.manifest()


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "h100bench/run.py"]
    assert bench["paths"] == ["h100bench"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in
                                            bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  spec.manifest()["workloads"]])
def test_every_cell_is_found_by_name(cell, bench):
    entry = next(c for c in bench["workloads"] if c["name"] == cell)
    found = spec.load_cell(cell)
    assert found.workload["config"] == entry["config"]
    assert found.workload["traffic"] == entry["traffic"]
    assert found.workload["chips"] == entry["chips"] == 1
    assert found.entry in ("serve", "train")
    assert "setup_s" in {m["name"] for m in found.end_to_end}
    assert len(found.end_to_end) >= 2 and found.per_layer
    for m in found.end_to_end + found.per_layer:
        assert callable(spec.reader(m["name"]))
    moved = {m["moves"] for m in found.per_layer}
    assert moved <= {m["name"] for m in found.end_to_end}


def test_config_files_are_the_manifest_files(bench):
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def _port(module: str):
    return importlib.import_module(f"biscuit_torch.{module}")


def test_config_arch_tables_are_the_ports():
    for path in sorted((spec.BENCH_DIR / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        fam = families.lookup(cfg["arch"]["family"])
        assert fam.port_arch(cfg["hp"]["model"], _port) == cfg["arch"], \
            path.name


def test_every_config_finds_its_family_and_counts():
    for path in sorted((spec.BENCH_DIR / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        fam = families.lookup(cfg["arch"]["family"])
        _, width = fam.param_specs(cfg["arch"])
        counts = importlib.import_module(f"h100bench.counts.{cfg['counts']}")
        assert counts.feature_dim(cfg["arch"]) == width, path.name
        assert counts.trunk_flops(cfg["arch"], cfg["hp"]["tile_px"]) > 0


def test_kernel_counts_are_discovered():
    counts = spec.kernel_counts()
    assert {"fused_preprocess", "fused_middle_flow", "mcd_head",
            "unit_bwd_strips"} <= set(counts)
    for mod in counts.values():
        assert callable(mod.call_bound) and len(mod.TARGET) == 2


def test_a_cell_added_as_files_is_found(tmp_path):
    bench, names = tiny.write(tmp_path, ("xception299.serve.b256",
                                         "resnet50.train.b128"))
    serve = tiny.load(tmp_path, bench, names["xception299.serve.b256"])
    assert serve.config["name"] == "xception299-nature2022-tiny-serve"
    assert serve.traffic["tiles_per_request"] == 4
    assert {m["name"] for m in serve.end_to_end} == {
        "serve_tiles_per_s", "serve_p95_ms", "setup_s"}
    assert "fused_middle_flow_roofline" in {m["name"] for m in
                                            serve.per_layer}
    train = tiny.load(tmp_path, bench, names["resnet50.train.b128"])
    assert {m["name"] for m in train.per_layer} == {
        "enqueue_ms.train", "library_ms.train", "idle.train", "mfu.train"}
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no.such.cell", base=tmp_path, bench=bench)
