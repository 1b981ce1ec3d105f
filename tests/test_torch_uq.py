"""The port's slice as a whole: uint8 tiles through
biscuit_torch.train.uq.UncertaintyInterface on a checkpoint saved by the
JAX package, against JAX mc_dropout_predict on the same tiles; device
selection; and the rule that the port imports nothing of JAX.

Tolerance at dropout 0: 2e-2 absolute on the softmax mean, the bound the
JAX package's own tests give bf16 paths against f32 ones
(tests/test_model_trainer.py:257). Both trunks compute in bf16; the
port's kernel route also carries the middle flow in f32 and runs the
head with bf16 matmul inputs.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch import resolve_device
from biscuit_torch.train.trainer import load_checkpoint
from biscuit_torch.models.xception import Head
from biscuit_torch.train.uq import (
    UncertaintyInterface,
    head_kernel_applicable,
    mc_dropout_full,
    mc_dropout_predict,
)
from biscuit_tpu.data.normalize import inference_preprocess, make_normalizer
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.train.trainer import init_model, save_checkpoint
from biscuit_tpu.train.uq import mc_dropout_predict as jax_predict

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _live_params(params, seed=0):
    """Positive BN shifts and doubled head weights: features that survive
    the relus and predictions that differ from tile to tile."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))

    def shift(tree):
        if "scale" in tree:
            tree["bias"] = rng.uniform(0.1, 0.3, tree["bias"].shape).astype(
                np.float32)
            return
        for sub in tree.values():
            if isinstance(sub, dict):
                shift(sub)

    shift(params["backbone"])
    for layer in params["head"].values():
        layer["kernel"] = (layer["kernel"] * 2).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    hp = ModelParams(model="xception_tiny", tile_px=32, hidden_layer_width=32,
                     dropout=0.0)
    model = build_model(hp)
    params, stats = init_model(model, hp, jax.random.PRNGKey(0))
    params = _live_params(params)
    stats = jax.tree_util.tree_map(np.asarray, unfreeze(stats))
    path = save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), params,
                           stats, hp, epoch=1, outcome="cohort", label="UQ",
                           kfold=None)
    tiles = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                              dtype=np.uint8)
    x = inference_preprocess(jnp.asarray(tiles), make_normalizer(hp.normalizer))
    want_m, want_s = jax_predict(model, params, stats, x,
                                 jax.random.PRNGKey(0), k=4, use_pallas=False,
                                 fused_trunk=False)
    return path, tiles, np.asarray(want_m), np.asarray(want_s)


@pytest.mark.parametrize("kernel_route", [False, True])
def test_interface_matches_jax_at_dropout_0(saved, kernel_route):
    """kernel_route=True runs the kernels' plain versions on the CPU:
    fused middle flow and the MC head."""
    path, tiles, want_m, want_s = saved
    ui = UncertaintyInterface(path, k=4, device="cpu",
                              use_kernel=kernel_route,
                              fused_trunk=kernel_route)
    assert ui.k == 4 and ui.hp.model == "xception_tiny"
    assert ui.wsi_normalizer is not None
    mean, std = ui(tiles)
    assert np.ptp(want_m[:, 0]) > 1e-3      # predictions vary by tile
    np.testing.assert_allclose(mean.numpy(), want_m, atol=2e-2)
    np.testing.assert_allclose(std.numpy(), want_s, atol=1e-3)
    single_m, _ = ui(tiles[0])
    np.testing.assert_allclose(single_m.numpy()[0], mean.numpy()[0],
                               atol=1e-6)


def test_fast_path_equals_full_passes_at_dropout_0(saved):
    path, tiles, _, _ = saved
    model, hp, _ = load_checkpoint(path, device="cpu")
    ui = UncertaintyInterface(path, device="cpu")
    x = torch.from_numpy(np.array(inference_preprocess(
        jnp.asarray(tiles), make_normalizer(hp.normalizer))))
    with torch.no_grad():
        fast = mc_dropout_predict(model, x, seed=0, k=3)
        full = mc_dropout_full(model, x, seed=0, k=3)
    for a, b in zip(fast, full):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert ui.seed == 0


def test_sampled_calls_differ_and_repeat_from_seed(saved):
    path, tiles, _, _ = saved
    model, hp, _ = load_checkpoint(path, device="cpu")
    model.head.dropout = model.dropout = 0.5
    outs = []
    for _ in range(2):
        ui = UncertaintyInterface.from_model(model, hp, k=8, device="cpu",
                                             seed=5, use_kernel=True,
                                             fused_trunk=True)
        outs.append([ui(tiles), ui(tiles)])
    (m1, s1), (m2, _) = outs[0]
    assert float(s1.mean()) > 0
    assert not torch.equal(m1, m2)
    torch.testing.assert_close(outs[1][0][0], m1, rtol=0, atol=0)


# (classes, hidden width, hidden layers, on the card, kernel): the kernel
# takes two hidden layers with F % 8 == H % 8 == 0 and 0 < C <= 128 on the
# card (the Pallas kernel's one lane tile); 129 classes, H = 1020, one
# hidden layer or the CPU go to the module head, as the reference's
# _pallas_applicable routes by shape.
@pytest.mark.parametrize("classes,width,layers,on_card,want", [
    (2, 1024, 2, True, True), (8, 1024, 2, True, True),
    (9, 1024, 2, True, True), (2, 1020, 2, True, False),
    (2, 1024, 1, True, False), (2, 1024, 2, False, False),
    (128, 1024, 2, True, True), (129, 1024, 2, True, False)])
def test_head_routing_follows_the_kernel_shapes(classes, width, layers,
                                                on_card, want):
    head = Head(2048, classes, layers, width, 0.1)
    assert head_kernel_applicable(head, on_card) is want


def test_interface_serves_a_33_class_head():
    """A 33-class head (tumour types): the interface on the kernel's route
    (its plain version on the CPU) equals mc_dropout_head_philox, the
    plain head of an exported program, which takes the kernel's
    arithmetic for every head the kernel takes, and the module head at
    dropout 0 within 2e-2
    (the kernel's route rounds the head's inputs to bf16, the module head
    runs f32)."""
    from biscuit_torch.data.normalize import inference_preprocess as prep
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import XceptionClassifier
    from biscuit_torch.train.uq import (
        mc_dropout_head,
        mc_dropout_head_philox,
        trunk_features,
    )

    hp = nature2022_params()
    hp.model, hp.tile_px, hp.dropout = "xception_tiny", 32, 0.0
    torch.manual_seed(0)
    model = XceptionClassifier(arch="xception_tiny", num_classes=33,
                               hidden_layers=2, hidden_width=32, dropout=0.0,
                               compute_dtype=torch.float32)
    with torch.no_grad():
        model.head.logits.weight.mul_(64.0)
    tiles = np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3),
                                              dtype=np.uint8)
    ui = UncertaintyInterface.from_model(model, hp, k=4, device="cpu",
                                         seed=3, use_kernel=True)
    mean, std = ui(tiles)
    assert mean.shape == std.shape == (4, 33)
    with torch.no_grad():
        x = prep(torch.from_numpy(tiles), ui.wsi_normalizer)
        feats = trunk_features(ui.model, x)
        want_m, want_s = mc_dropout_head_philox(ui.model, feats, 3, k=4)
        mod_m, mod_s = mc_dropout_head(ui.model, feats, k=4,
                                       use_kernel=False)
    torch.testing.assert_close(mean, want_m, rtol=0, atol=1e-6)
    torch.testing.assert_close(std, want_s, rtol=0, atol=1e-6)
    assert float(mod_m.max()) > 2.0 / 33       # not a uniform softmax
    np.testing.assert_allclose(mean.numpy(), mod_m.numpy(), atol=2e-2)
    np.testing.assert_allclose(std.numpy(), mod_s.numpy(), atol=1e-6)


def test_entry_points_need_a_card_unless_cpu(saved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = saved[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        load_checkpoint(path)
    with pytest.raises(RuntimeError):
        UncertaintyInterface(path)
    assert resolve_device("cpu").type == "cpu"


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "biscuit_tpu")


def _port_files():
    return sorted((REPO / "biscuit_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """Every import statement, at any depth, in the port and chip_smoke."""
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_importing_the_port_loads_no_jax():
    mods = ["biscuit_torch." + ".".join(
        p.relative_to(REPO / "biscuit_torch").with_suffix("").parts)
        for p in _port_files()[:-1]]
    mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
