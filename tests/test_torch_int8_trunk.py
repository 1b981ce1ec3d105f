"""The port's w8a8 trunk (biscuit_torch/ops/int8_trunk.py) and its wiring
in biscuit_torch/train/uq.py, against the JAX package's
(biscuit_tpu/ops/int8_trunk.py) on the same numpy parameters and tiles,
on the CPU at ``xception_tiny`` and 64 px.

Tolerances:

* folding and quantization are host numpy in the same operation order,
  so ``qk``, ``inv_s_in``, ``eff`` and ``shift`` are equal bit for bit
  from the same scales;
* the int8 products are integer arithmetic: the int32 accumulators are
  equal exactly;
* calibration runs f32 convs whose outputs are rounded to bf16. The two
  packages' f32 convs sum in different orders, so where a value lies
  next to a bf16 rounding boundary the packages round it to neighbouring
  bf16 values, and the difference travels on: a site's absmax may differ
  by a bf16 ulp of itself, at most 2**-7 relative. The check allows two
  (2**-6);
* int8 features at the same scales: a bf16 activation that differs
  between the packages can move an int8 code by one, which moves a pooled
  feature by far less than 1e-2 of the largest; the check allows that;
* against the f32 trunk, the JAX package's own bounds
  (tests/test_int8_trunk.py): cosine > 0.98, relative L2 < 0.2 (0.25
  with the middle quantized).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.ops import int8_trunk as port
from biscuit_torch.train.trainer import load_checkpoint
from biscuit_torch.train.uq import UncertaintyInterface, mc_dropout_predict
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import ARCHS, build_model
from biscuit_tpu.ops import int8_trunk as ref
from biscuit_tpu.train.trainer import init_model, save_checkpoint
from biscuit_tpu.train.uq import UncertaintyInterface as JaxInterface

torch.set_num_threads(1)
PX = 64
CFG = ARCHS["xception_tiny"]
SCALE_RTOL = 2.0 ** -6
FEATURE_TOL = 1e-2


def _batch(seed, n=4):
    """Standardized-tile statistics, as the JAX package's test."""
    return np.random.default_rng(seed).standard_normal(
        (n, PX, PX, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One JAX-initialized xception_tiny saved as a model dir; the JAX
    model with its params and the port's model loaded from the dir."""
    hp = ModelParams(model="xception_tiny", tile_px=PX, tile_um=PX,
                     hidden_layer_width=32, hidden_layers=2, dropout=0.0,
                     normalizer=None, uq_samples=2)
    model = build_model(hp)
    params, stats = init_model(model, hp, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    stats = jax.tree_util.tree_map(np.asarray, unfreeze(stats))
    path = save_checkpoint(str(tmp_path_factory.mktemp("int8")), params,
                           stats, hp, epoch=1, outcome="cohort", label="Q",
                           kfold=None)
    tmodel, _, _ = load_checkpoint(path, device="cpu")
    return model, params, stats, tmodel, path


@pytest.fixture(scope="module", params=[False, True], ids=["default",
                                                           "quant_middle"])
def calibrated(request, tiny):
    """Both packages calibrated on the same batch, the port's weights
    quantized at the JAX package's scales, and both packages' int8 and
    the f32 features of a held-out batch."""
    model, params, stats, tmodel, _ = tiny
    qm = request.param
    x_cal, x = _batch(3), _batch(4)
    sj = ref.calibrate_int8_trunk(model, params, stats, jnp.asarray(x_cal),
                                  quant_middle=qm)
    st = port.calibrate_int8_trunk(tmodel, torch.from_numpy(x_cal),
                                   quant_middle=qm)
    qj = ref.prepare_int8_trunk(model, params, stats, sj)
    qt = port.prepare_int8_trunk(tmodel, sj)
    fj = np.asarray(ref.trunk_features_int8(model, params, stats,
                                            jnp.asarray(x), qj))
    ft = port.trunk_features_int8(tmodel, torch.from_numpy(x), qt).numpy()
    with torch.no_grad():
        f32 = tmodel.features(torch.from_numpy(x)).numpy()
    return qm, sj, st, qj, qt, fj, ft, f32


@pytest.mark.parametrize("include_middle", [False, True])
def test_fold_matches_jax(tiny, include_middle):
    model, params, stats, tmodel, _ = tiny
    fj = ref._fold_trunk(params, stats, CFG, include_middle=include_middle)
    ft = port._fold_trunk(tmodel, CFG, include_middle=include_middle)
    assert list(fj) == list(ft)
    for name, want in fj.items():
        got = ft[name]
        if isinstance(want, dict):
            for key in want:
                assert got[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], want[key])
        else:   # depthwise: bf16 both, same values
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_calibration_matches_jax(calibrated):
    qm, sj, st, *_ = calibrated
    assert sorted(st) == sorted(sj)
    n_sites = 2 + 3 * (len(CFG["entry_blocks"]) + 1) + len(CFG["exit_convs"])
    n_sites += 3 * CFG["middle_repeats"] if qm else 0
    assert len(st) == n_sites
    for site in sj:
        assert st[site] > 0 and np.isfinite(st[site])
        np.testing.assert_allclose(st[site], sj[site], rtol=SCALE_RTOL,
                                   err_msg=site)


def test_quantized_weights_equal_jax_bit_for_bit(calibrated):
    qm, sj, st, qj, qt, *_ = calibrated
    assert list(qt) == list(qj)
    n_int8 = 0
    for name, want in qj.items():
        got = qt[name]
        if not isinstance(want, dict):
            assert got.dtype == torch.bfloat16
            continue
        n_int8 += 1
        for key in ("k", "inv_s_in", "eff", "shift"):
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert g.dtype == w.dtype, (name, key)
            assert g.tobytes() == w.tobytes(), (name, key)
    assert n_int8 == len(sj)
    assert any(n.startswith("middle") for n in qt) is qm


# (site, stride, input spatial size): a 1x1/s1 pointwise, the 1x1/s2
# residual at an odd and an even size, and the 3x3 VALID stems.
@pytest.mark.parametrize("site,stride,hw", [
    ("entry1.pw0", 1, 15), ("entry1.res", 2, 15), ("entry2.res", 2, 8),
    ("conv1", 2, 33), ("conv2", 1, 16)])
def test_int8_conv_accumulators_equal_jax(calibrated, site, stride, hw):
    qt = calibrated[4]
    w = qt[site]
    cin = w["k"].shape[2]
    q = np.random.default_rng(7).integers(-127, 128, (3, hw, hw, cin),
                                          dtype=np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w["k"]), (stride, stride),
        "VALID" if site.startswith("conv") else "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    placed = port.place_int8_trunk({site: w}, "cpu")[site]
    got = port._int8_conv(torch.from_numpy(q), placed, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_features_match_jax(calibrated):
    *_, fj, ft, _ = calibrated
    assert ft.shape == fj.shape and np.all(np.isfinite(ft))
    err = np.abs(ft - fj).max()
    assert err <= FEATURE_TOL * np.abs(fj).max(), err


def test_int8_features_close_to_f32(calibrated):
    qm, *_, ft, f32 = calibrated
    a, b = ft.astype(np.float64), f32.astype(np.float64)
    cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                   * np.linalg.norm(b, axis=1))
    assert cos.min() > 0.98, cos
    rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    assert rel.max() < (0.25 if qm else 0.2), rel


def test_calibrator_accumulates(tiny):
    tmodel = tiny[3]
    cal = port.Int8Calibrator(tmodel)
    with pytest.raises(ValueError, match="before any update"):
        cal.scales()
    cal.update(torch.from_numpy(_batch(7)))
    s1 = cal.scales()
    cal.update(torch.from_numpy(_batch(8) * 3.0))
    s2 = cal.scales()
    assert cal.n_tiles == 8
    assert all(s2[k] >= s1[k] for k in s1) and any(s2[k] > s1[k] for k in s1)


def test_predict_rejects_non_xception_and_fuse_blocks(tiny, calibrated):
    tmodel, qt = tiny[3], calibrated[4]
    x = torch.from_numpy(_batch(9, n=2))
    with pytest.raises(ValueError, match="fuse_blocks"):
        mc_dropout_predict(tmodel, x, k=2, int8_qw=qt, fuse_blocks=True)
    tmodel.arch = "resnet18"
    try:
        with pytest.raises(ValueError, match="int8 trunk"):
            mc_dropout_predict(tmodel, x, k=2, int8_qw=qt)
    finally:
        tmodel.arch = "xception_tiny"


# --- UncertaintyInterface(int8_trunk=True) -------------------------------

def _tiles(seed, n=4):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3),
                                                dtype=np.uint8)


def test_interface_calibrates_exactly_then_serves_int8(tiny, tmp_path):
    path = tiny[4]
    cal = str(tmp_path / "int8_calibration.json")
    plain = UncertaintyInterface(path, device="cpu", seed=3)
    q = UncertaintyInterface(path, device="cpu", seed=3, int8_trunk=True,
                             calib_tiles=8, calibration_path=cal)
    for i in range(2):      # 8 calibration tiles, answered as without int8
        tiles = _tiles(i)
        for a, b in zip(q(tiles), plain(tiles)):
            assert torch.equal(a, b)
        assert (q._qw is None) is (i == 0)
    assert os.path.exists(cal)
    mean8, std8 = q(_tiles(5))
    mean, _ = plain(_tiles(5))
    assert torch.isfinite(mean8).all() and torch.isfinite(std8).all()
    np.testing.assert_allclose(mean8.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(mean8.numpy(), mean.numpy(), atol=0.05)

    # A second interface from the saved file serves int8 from its first
    # call, equal to the first interface bit for bit.
    again = UncertaintyInterface(path, device="cpu", seed=3, int8_trunk=True,
                                 calibration_path=cal)
    assert again._qw is not None and again._scales == q._scales
    for a, b in zip(again(_tiles(5), seed=11), q(_tiles(5), seed=11)):
        assert torch.equal(a, b)


def test_calibration_files_cross_packages(tiny, calibrated, tmp_path,
                                          monkeypatch):
    qm, sj = calibrated[0], calibrated[1]
    path = tiny[4]
    if qm:
        monkeypatch.setenv("BISCUIT_INT8_MIDDLE", "1")
    else:
        monkeypatch.delenv("BISCUIT_INT8_MIDDLE", raising=False)

    # The JAX package writes, the port reads.
    jax_file = str(tmp_path / "jax.json")
    writer = JaxInterface(path, int8_trunk=True)
    writer._scales = sj
    writer.save_calibration(jax_file)
    got = UncertaintyInterface(path, device="cpu", int8_trunk=True,
                               calibration_path=jax_file)
    assert got._scales == sj and got._qw is not None

    # The port writes, the JAX package reads.
    port_file = str(tmp_path / "port.json")
    got.save_calibration(port_file)
    with open(port_file) as f, open(jax_file) as g:
        assert json.load(f) == json.load(g)
    reader = JaxInterface(path, int8_trunk=True, calibration_path=port_file)
    assert reader._scales == sj and reader._qw is not None


def test_stale_mismatched_or_corrupt_calibration_recalibrates(
        tiny, tmp_path, monkeypatch):
    monkeypatch.delenv("BISCUIT_INT8_MIDDLE", raising=False)
    path = tiny[4]
    sj = port.calibrate_int8_trunk(tiny[3], torch.from_numpy(_batch(3)))
    good = UncertaintyInterface(path, device="cpu", int8_trunk=True)
    good._scales = sj
    base = str(tmp_path / "good.json")
    good.save_calibration(base)
    with open(base) as f:
        blob = json.load(f)

    def write(name, text):
        p = str(tmp_path / name)
        with open(p, "w") as f:
            f.write(text)
        return p

    cases = {
        "stale": write("stale.json", json.dumps(
            {**blob, "weights_blake2b": "0" * 32})),
        "corrupt": write("corrupt.json", json.dumps(blob)[:40]),
        "format": write("format.json", json.dumps({"scales": [1.0]})),
        "incomplete": write("incomplete.json", json.dumps(
            {**blob, "scales": {"conv1": 0.1}})),
    }
    for name, p in cases.items():
        ui = UncertaintyInterface(path, device="cpu", int8_trunk=True,
                                  calibration_path=p)
        assert ui._qw is None and ui._scales is None, name
    monkeypatch.setenv("BISCUIT_INT8_MIDDLE", "1")
    ui = UncertaintyInterface(path, device="cpu", int8_trunk=True,
                              calibration_path=base)
    assert ui._qw is None, "middle setting"
    monkeypatch.delenv("BISCUIT_INT8_MIDDLE")
    ui = UncertaintyInterface(path, device="cpu", int8_trunk=True,
                              calibration_path=base)
    assert ui._qw is not None and ui._scales == sj


def test_interface_refuses_resnet_and_fuse_blocks(tiny):
    from biscuit_torch.hp import ModelParams as PortParams
    from biscuit_torch.models.xception import build_model as port_build

    path = tiny[4]
    with pytest.raises(ValueError, match="fuse_blocks"):
        UncertaintyInterface(path, device="cpu", int8_trunk=True,
                             fuse_blocks=True)
    hp = PortParams(model="resnet_tiny", tile_px=PX, hidden_layer_width=16)
    with pytest.raises(ValueError, match="int8 trunk is Xception's"):
        UncertaintyInterface.from_model(port_build(hp), hp, device="cpu",
                                        int8_trunk=True)
