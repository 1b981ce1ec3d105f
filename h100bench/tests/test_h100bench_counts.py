"""The yardstick's arithmetic: FLOPs held against the port's analytic
count and a hand sum of ResNet-50's layer table, kernel bounds against
the "bound ms" column of PERF.md's kernel table."""

import json
import math

import pytest

from h100bench.counts import (
    fused_middle_flow,
    fused_preprocess,
    mcd_head,
    model,
    resnet,
    unit_bwd_strips,
    xception,
)
from h100bench.counts.peaks import bound_s
from h100bench.harness import spec


def _config(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json")
                      .read_text())


def test_xception_flops_are_the_ports():
    from biscuit_torch.models import flops

    cfg = _config("xception299-nature2022")
    assert xception.trunk_flops(cfg["arch"], 299) == flops.trunk_flops()
    assert model.serve_flops_per_tile(cfg) == flops.uq_flops_per_tile()
    assert model.train_flops_per_tile(cfg) == flops.train_flops_per_tile()


def test_resnet50_flops_by_hand():
    # (output size, cin, cout, k) of every conv at 299 px, SAME padding:
    # the stem 150, pool 75, stages at 75, 38, 19, 10.
    table = [(150, 3, 64, 7)]
    for size, f, n, cin in ((75, 64, 3, 64), (38, 128, 4, 256),
                            (19, 256, 6, 512), (10, 512, 3, 1024)):
        table.append((size, cin, 4 * f, 1))                 # projection
        for b in range(n):
            c = cin if b == 0 else 4 * f
            # v1.5: the stride is on the 3x3, so the first 1x1 runs at
            # the input's size (75, 38, 19 for the strided stages).
            first = {38: 75, 19: 38, 10: 19}.get(size, 75) if b == 0 \
                else size
            table += [(first, c, f, 1), (size, f, f, 3), (size, f, 4 * f, 1)]
    hand = sum(2 * s * s * co * k * k * ci for s, ci, co, k in table)
    cfg = _config("resnet50-nature2022")
    assert resnet.trunk_flops(cfg["arch"], 299) == hand
    assert resnet.feature_dim(cfg["arch"]) == 2048
    head = 2 * 2048 * 1024 + 2 * 1024 * 1024 + 2 * 1024 * 2
    assert model.serve_flops_per_tile(cfg) == hand + 30 * head
    assert model.train_flops_per_tile(cfg) == 3 * (hand + head)


# PERF.md's kernel table, "bound ms (by)", 256 tiles or batch 128.
@pytest.mark.parametrize("got, ms, by", [
    (fused_preprocess.bound(256, 299, 299), 0.0615, "bytes"),
    (fused_middle_flow.bound(256, 19, 19, 728, 24), 2.377, "operations"),
    (mcd_head.bound(256, 2048, 1024, 2, 30), 0.0174, "operations"),
])
def test_kernel_bounds_match_the_kernel_table(got, ms, by):
    assert got[0] * 1e3 == pytest.approx(ms, rel=2e-3)
    assert got[1] == by


def test_unit_backward_bound_reads_each_byte_once():
    # The table's 1.303 = 1.163 + 0.141 ms counts the BN sums' second read
    # of gy and p; the benchmark's roofline counts each byte once.
    parts = []
    for hw, ci, co in ((147, 64, 128), (19, 728, 728)):
        again = bound_s(unit_bwd_strips.read_once_bytes(128, hw, ci, co)
                        + unit_bwd_strips.bn_reread_bytes(128, hw, co),
                        unit_bwd_strips.ops(128, hw, ci, co))
        parts.append(again[0] * 1e3)
        once = unit_bwd_strips.bound(128, hw, ci, co)
        assert once[0] < again[0]
        m = 128 * hw * hw
        assert unit_bwd_strips.read_once_bytes(128, hw, ci, co) == \
            m * (2 * co + 3 * ci) * 2
    assert parts[0] == pytest.approx(1.163, rel=2e-3)
    assert parts[1] == pytest.approx(0.141, rel=5e-3)
    assert sum(parts) == pytest.approx(1.303, rel=2e-3)


def test_call_bounds_read_the_call_shapes():
    import torch

    x = torch.empty((256, 299, 299, 3), dtype=torch.uint8, device="meta")
    assert fused_preprocess.call_bound((x, None), {}) == \
        fused_preprocess.bound(256, 299, 299)
    h = torch.empty((256, 19, 19, 728), dtype=torch.bfloat16, device="meta")
    dw = torch.empty((24, 9, 728), device="meta")
    assert fused_middle_flow.call_bound((h, dw, None, None, None), {}) == \
        fused_middle_flow.bound(256, 19, 19, 728, 24)
    f = torch.empty((256, 2048), device="meta")
    w = [torch.empty(s, device="meta") for s in
         ((2048, 1024), (1024,), (1024, 1024), (1024,), (1024, 2), (2,))]
    assert mcd_head.call_bound((f, w, None, 30, 0.1), {}) == \
        mcd_head.bound(256, 2048, 1024, 2, 30)
    gy = torch.empty((128, 19, 19, 1024), device="meta")
    r = torch.empty((128, 19, 19, 728), device="meta")
    args = ("unit_bwd_strips", gy, r)
    assert unit_bwd_strips.applies(args, {})
    assert not unit_bwd_strips.applies(("unit_bwd_plane", gy, r), {})
    assert unit_bwd_strips.call_bound(args, {}) == \
        unit_bwd_strips.bound(128, 19, 728, 1024)


def test_bound_is_the_larger_time():
    t, by = bound_s(3.35e12, {"bf16": 989e12 / 2})
    assert (t, by) == (1.0, "bytes")
    t, by = bound_s(0.0, {"bf16": 989e12, "f32": 67e12 * 2})
    assert by == "operations" and math.isclose(t, 2.0)
