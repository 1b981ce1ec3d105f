"""The port's ViT family (biscuit_torch/models/vit.py) against the plain
reference of the benchmark (h100bench/reference/families/vit.py), on the
benchmark's seeded random weights, and the ``hp.model`` registry, FLOP
count and tracing around it. The JAX package has no ViT to compare with.

Tolerances: in f32 the port and the reference compute the same sums in
other orders (fused attention against the written-out softmax, addcmul
against a product and a sum), so the features agree to about 1e-6 of
their norm; 1e-4 leaves room for the CPU's summation order. In bf16 the port
rounds every GEMM input to 8 bits of mantissa (2**-8 relative) through
two blocks: 3e-2, as the other families' bf16 tests. The MC mean and std
go through the head kernel's plain version, which rounds the head's
weights and activations to bf16 as the kernel does: the limits of the
benchmark's tiny ViT cell (h100bench/tests/test_h100bench_vit.py), 0.2 in
units of the softmax's slope and 0.009. Each planted mistake moves the
features by more than a tenth of their norm."""

import importlib
import json
import math

import numpy as np
import pytest
import torch

from biscuit_torch import tracing
from biscuit_torch.hp import ModelParams
from biscuit_torch.models import flops, vit
from biscuit_torch.models.xception import build_model, feature_dim
from biscuit_torch.train.uq import UncertaintyInterface
from h100bench.counts import model as bench_model
from h100bench.counts import vit as bench_vit
from h100bench.harness import check, spec
from h100bench.harness.traffic import tile_pool
from h100bench.harness.weights import make
from h100bench.reference import nets, serve
from h100bench.reference.families import vit as ref_vit
from h100bench.reference.preprocess import preprocess

F32_TOL = 1e-4
BF16_TOL = 3e-2
SEED = 2 ** 31 + 17

torch.set_num_threads(1)


def _port(module):
    return importlib.import_module(f"biscuit_torch.{module}")


def _config(arch="vit_tiny"):
    cfg = json.loads((spec.BENCH_DIR / "configs"
                      / "uni2h-vith14-nature2022.json").read_text())
    if arch != "uni2_h":
        cfg["arch"] = ref_vit.port_arch(arch, _port)
        cfg["hp"].update(model=arch, tile_px=cfg["arch"]["img_size"],
                         hidden_layer_width=32, uq_samples=4)
    return cfg


def _model(cfg, dtype="float32", seed=SEED):
    hp = ModelParams.from_dict({**cfg["hp"], "compute_dtype": dtype})
    weights = make(cfg, seed, "cpu")
    model = build_model(hp)
    model.load_state_dict(weights, strict=True)
    return hp, model.eval(), weights


def _tiles(cfg, n=6, seed=3):
    return tile_pool(n, cfg["hp"]["tile_px"], seed, "cpu")


def _rel(a, b):
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def _features(model, tiles):
    with torch.no_grad():
        return model.features(preprocess(torch.as_tensor(tiles),
                                         "reinhard_fast"))


def _reference(cfg, weights, tiles):
    with torch.no_grad():
        return nets.features(preprocess(torch.as_tensor(tiles),
                                        "reinhard_fast"), weights, cfg)


@pytest.mark.parametrize("dtype, tol", [("float32", F32_TOL),
                                        ("bfloat16", BF16_TOL)])
def test_features_match_the_reference(dtype, tol):
    cfg = _config()
    _, model, weights = _model(cfg, dtype)
    tiles = _tiles(cfg)
    got = _features(model, tiles)
    assert got.dtype == torch.float32 and got.shape == (6, 32)
    assert _rel(got, _reference(cfg, weights, tiles)) <= tol


def test_mc_mean_and_std_match_the_reference():
    cfg = _config()
    hp, model, weights = _model(cfg)
    tiles = _tiles(cfg, 8)
    ui = UncertaintyInterface.from_model(model, hp, device="cpu",
                                         use_kernel=True)
    assert not ui._fused
    got = [tuple(t.numpy() for t in ui(tiles, seed=s)) for s in (5, 6)]
    want = [serve.request(tiles, s, weights, cfg, "cpu") for s in (5, 6)]
    numbers = check.serve_numbers(got, want)
    assert numbers["mean_logit_gap"] <= 0.2, numbers
    assert numbers["std_gap"] <= 0.009, numbers
    assert float(np.max(got[0][1])) > 0


def _pos_on_prefix(self, x):
    # The position table added to the first tokens of the whole sequence:
    # the prefix tokens take rows of it, the last patches none.
    dt = self.compute_dtype
    h = torch.nn.functional.conv2d(
        x.to(dt), self.patch.weight.to(dt), self.patch.bias.to(dt),
        stride=self.patch.stride).flatten(2).transpose(1, 2).float()
    prefix = torch.cat([self.cls_token, self.reg_token], dim=1)
    seq = torch.cat([prefix.expand(h.shape[0], -1, -1), h], dim=1)
    n = self.pos_embed.shape[1]
    return torch.cat([seq[:, :n] + self.pos_embed, seq[:, n:]], dim=1)


_EMBED = vit.ViTBackbone.embed


def _reg_first(self, x):
    seq = _EMBED(self, x)
    k = self.reg_token.shape[1]
    return torch.cat([seq[:, 1:1 + k], seq[:, :1], seq[:, 1 + k:]], dim=1)


def _gate_last(x, fc1_w, fc1_b, fc2_w, fc2_b):
    a, b = torch.nn.functional.linear(x, fc1_w, fc1_b).chunk(2, dim=-1)
    return torch.nn.functional.linear(a * torch.nn.functional.silu(b),
                                      fc2_w, fc2_b)


@pytest.mark.parametrize("mistake", ["pos_on_prefix", "wrong_token_order",
                                     "gate_on_second_half",
                                     "layer_scale_left_out"])
def test_a_wrong_mechanism_fails_the_comparison(mistake, monkeypatch):
    cfg = _config()
    _, model, weights = _model(cfg)
    if mistake == "pos_on_prefix":
        monkeypatch.setattr(vit.ViTBackbone, "embed", _pos_on_prefix)
    elif mistake == "wrong_token_order":
        monkeypatch.setattr(vit.ViTBackbone, "embed", _reg_first)
    elif mistake == "gate_on_second_half":
        monkeypatch.setattr(vit, "swiglu_mlp", _gate_last)
    else:       # LayerScale of 1 is the block without it
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".gamma"):
                    p.fill_(1.0)
    tiles = _tiles(cfg)
    assert _rel(_features(model, tiles),
                _reference(cfg, weights, tiles)) > 1000 * F32_TOL


def test_uni2_h_is_the_published_trunk():
    hp = ModelParams(model="uni2_h", tile_px=224)
    with torch.device("meta"):
        model = build_model(hp)
    b = model.backbone
    assert isinstance(b, vit.ViTBackbone) and model.arch == "uni2_h"
    assert sum(p.numel() for p in b.parameters()) == 681_394_176
    blocks = [m for m in b.modules() if isinstance(m, vit.ViTBlock)]
    assert len(blocks) == 24 and blocks[0].heads == 24
    assert tuple(blocks[0].qkv.weight.shape) == (3 * 1536, 1536)
    assert tuple(blocks[0].fc1.weight.shape) == (8192, 1536)
    assert tuple(blocks[0].fc2.weight.shape) == (1536, 4096)
    assert tuple(b.reg_token.shape) == (1, 8, 1536)
    assert tuple(b.pos_embed.shape) == (1, 256, 1536)
    assert model.head.hidden0.in_features == feature_dim(hp) == 1536
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in model.modules())
    assert ref_vit.port_arch("uni2_h", _port) == _config("uni2_h")["arch"]


def test_flops_agree_with_the_benchmarks_count():
    cfg = _config("uni2_h")
    want = 370_940_461_056
    assert flops.trunk_flops("uni2_h", 224) == want
    assert bench_vit.trunk_flops(cfg["arch"], 224) == want
    assert flops.uq_flops_per_tile("uni2_h", 224) == \
        bench_model.serve_flops_per_tile(cfg)
    assert flops.train_flops_per_tile("uni2_h", 224) == \
        bench_model.train_flops_per_tile(cfg)
    tiny = _config()
    assert flops.trunk_flops("vit_tiny", 32) == \
        bench_vit.trunk_flops(tiny["arch"], 32)
    # A 256-tile request: 95.0 TFLOP.
    assert math.isclose(256 * flops.uq_flops_per_tile("uni2_h", 224),
                        95.0e12, rel_tol=1e-3)


def test_a_tile_of_another_size_is_refused():
    cfg = _config()
    _, model, _ = _model(cfg)
    with pytest.raises(ValueError, match="32-px tiles"):
        model.features(torch.zeros(1, 40, 40, 3))


def test_attention_counter_and_spans():
    cfg = _config()
    _, model, _ = _model(cfg)
    x = preprocess(torch.as_tensor(_tiles(cfg, 2)), "reinhard_fast")
    vit.reset_attention_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, torch.no_grad():
        model.features(x)
    assert vit.attention_counts() == {"math": 2}
    names = [e.name for e in prof.events()
             if e.name.startswith(tracing.PREFIX + "vit.")]
    assert names.count("biscuit.vit.embed") == 1
    assert names.count("biscuit.vit.attention") == 2
    assert names.count("biscuit.vit.mlp") == 2
    assert names.count("biscuit.vit.norm") == 1
    vit.reset_attention_counts()
    assert vit.attention_counts() == {}


def test_a_train_step_without_batchnorm():
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    cfg = _config()
    hp, model, weights = _model(cfg)
    tx = make_optimizer(hp, model.parameters())
    step = make_train_step(model, tx, hp, make_normalizer(hp.normalizer),
                           device="cpu")
    tiles = _tiles(cfg, 4)
    out = step(tiles, np.array([0, 1, 1, 0]), np.ones(4, np.float32),
               torch.Generator().manual_seed(1))
    assert math.isfinite(float(out["loss"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    # The key bias shifts every score of a query alike, which the softmax
    # ignores: its gradient is round-off, the query's and value's are not.
    d = cfg["arch"]["width"]
    qkv_b = grads["backbone.block0.qkv.bias"]
    assert qkv_b[d:2 * d].norm() < 1e-4 * qkv_b[2 * d:].norm()
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), weights[n])]
    assert len(moved) == len(grads)
