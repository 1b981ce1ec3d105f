"""The port's servables (biscuit_torch/serve.py, torch.export) on the CPU,
against the port's own routes and the JAX package's servable.

One set of weights: an ``xception_tiny`` model in f32 (32 px, 2 x 32
head, K=4, reinhard_fast), initialized by the port with positive BN
shifts and a doubled head, so that features survive the relus and
predictions differ by tile; saved at dropout 0.5 (the sampling tests)
and 0 (the parity tests). One module-scoped export a route: the op
graph (``use_kernels=True``: the registered ops, which run their plain
versions on the CPU) and the portable program (``use_kernels=False``).
Tolerances:

- an artifact against the same route composed by hand from the port's
  functions, at the same seed: 0 (the export replays the same ops);
- against the JAX servable from the same model dir at dropout 0: 2e-3 on
  the mean (tighter than ``tests/test_torch_uq.py``'s 2e-2: the model is
  f32, and only the head's bf16 operands, and in the op graph the bf16
  preprocess, differ; 3e-4 and 8e-4 measured, against a spread of 0.024
  over the tiles) and 1e-6 on the std, 0 on both sides;
- a heatmap, tile export and feature dump from an artifact against the
  model dir's: in ``tests/test_torch_heatmap.py``.
"""

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from biscuit_torch import serve
from biscuit_torch.cli.export import main as export_cli
from biscuit_torch.cli.predict import main as predict_cli
from biscuit_torch.data.normalize import (
    ReinhardFastNormalizer,
    make_normalizer,
    per_image_standardization,
)
from biscuit_torch.data.slide import WSI
from biscuit_torch.data.tfrecord import TFRecordWriter
from biscuit_torch.hp import ModelParams
from biscuit_torch.models.xception import BatchNorm, Head, build_model
from biscuit_torch.mosaic import generate_features
from biscuit_torch.ops import library
from biscuit_torch.ops.fused_preprocess import coefficients, fused_preprocess
from biscuit_torch.ops.mcd_head import (
    head_weights,
    mcd_head_reference,
    philox_dropout_bits,
    seed_tensor,
)
from biscuit_torch.train.trainer import (
    init_model,
    load_checkpoint,
    save_checkpoint,
)
from biscuit_torch.train.uq import (
    mc_dropout_head,
    mc_dropout_head_philox,
    trunk_features,
)
from biscuit_tpu import serve as jax_serve
from chip_smoke import encode_png

torch.set_num_threads(1)
BATCH = 8
PX = 32


def _hp(dropout, layers=2):
    return ModelParams(model="xception_tiny", tile_px=PX, tile_um=PX,
                       hidden_layer_width=32, hidden_layers=layers,
                       dropout=dropout, uq=True, uq_samples=4,
                       normalizer="reinhard_fast", compute_dtype="float32")


def _save(root, dropout, layers=2, outcome_labels=None):
    hp = _hp(dropout, layers)
    model = init_model(build_model(hp), hp, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.bias.copy_(torch.from_numpy(rng.uniform(
                    0.1, 0.3, mod.bias.shape).astype(np.float32)))
        for lin in model.head.modules():
            if isinstance(lin, torch.nn.Linear):
                lin.weight.mul_(2)
    return save_checkpoint(str(root / f"m{dropout}-{layers}"), model, hp,
                           epoch=1, outcome="cohort", label="SV", kfold=None,
                           outcome_labels=outcome_labels)


def _tiles(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Model dirs at dropout 0.5 and 0 and their artifacts: the op graph
    with the feature program (``ops``), the portable one (``portable``,
    with features at dropout 0.5 only)."""
    root = tmp_path_factory.mktemp("servable")
    dirs = {d: _save(root, d) for d in (0.5, 0.0)}
    arts = {}
    for d, model_dir in dirs.items():
        arts[d, "ops"] = serve.export_servable(
            model_dir, str(root / f"ops{d}.biscuit"), batch_size=BATCH,
            use_kernels=True, device="cpu")
        arts[d, "portable"] = serve.export_servable(
            model_dir, str(root / f"portable{d}.biscuit"),
            batch_size=BATCH, use_kernels=False, device="cpu",
            with_features=d > 0)
    return root, dirs, arts


@pytest.fixture(scope="module")
def loaded(env):
    """One loaded servable an artifact, for the tests that pass their
    seeds (a load of the portable program takes seconds)."""
    cache = {}

    def get(dropout, route):
        if (dropout, route) not in cache:
            cache[dropout, route] = serve.load_servable(
                env[2][dropout, route], device="cpu")
        return cache[dropout, route]

    return get


@pytest.fixture(scope="module")
def jax_artifact(env):
    """The JAX package's servable of the dropout-0 model dir."""
    root, dirs, _ = env
    return jax_serve.export_servable(dirs[0.0], str(root / "jax.biscuit"),
                                     batch_size=BATCH, with_features=False)


def _by_hand(model_dir, tiles, seed, route, k=None, features=False):
    """The route composed from the port's functions, as the artifact's
    program composes it."""
    model, hp, _ = load_checkpoint(model_dir, "cpu")
    k = k or hp.uq_samples
    x = torch.from_numpy(tiles)
    with torch.no_grad():
        if route == "ops":
            x = fused_preprocess(x, make_normalizer(hp.normalizer))
            feats = trunk_features(model, x, fused_trunk=True)
            mean, std = mc_dropout_head(model, feats, seed, k,
                                        use_kernel=True)
        else:
            x = per_image_standardization(
                make_normalizer(hp.normalizer)(x.float()))
            feats = model.features(x)
            mean, std = mc_dropout_head_philox(model, feats,
                                               seed_tensor(seed), k)
    return (feats, mean, std) if features else (mean, std)


class TestContainer:
    def test_header(self, env):
        _, dirs, arts = env
        sv = serve.load_servable(arts[0.5, "ops"], device="cpu")
        h = sv.header
        assert h["format_version"] == "torch-1"
        assert (h["arch"], h["tile_px"], h["tile_um"]) == (
            "xception_tiny", PX, PX)
        assert (h["batch_size"], h["k"], h["features_k"]) == (BATCH, 4, 8)
        assert h["normalizer"] == "reinhard_fast"
        assert h["platforms"] == ["cpu"] and h["device"] == "cpu"
        assert h["use_kernels"] is True and h["fuse_blocks"] is False
        assert h["torch_version"] == torch.__version__
        assert h["seed_dtype"] == "int64"
        assert h["weights_blake2b"] == serve._weights_digest(dirs[0.5])
        assert h["outcome_labels"] is None
        assert set(h["programs"]) == set(h["checksums"]) == {"uq",
                                                             "features"}
        assert (sv.batch_size, sv.tile_px, sv.tile_um, sv.k,
                sv.features_k) == (BATCH, PX, PX, 4, 8)
        assert sv.platforms == ("cpu",) and sv.has_features
        portable = serve.load_servable(arts[0.0, "portable"], device="cpu")
        assert portable.header["use_kernels"] is False
        assert not portable.has_features
        assert portable.header["features_k"] is None

    def test_default_output_path(self, env, tmp_path):
        _, dirs, _ = env
        model_dir = str(tmp_path / "copy")
        shutil.copytree(dirs[0.0], model_dir)
        path = serve.export_servable(model_dir, batch_size=2,
                                     use_kernels=True, device="cpu",
                                     with_features=False)
        assert path == os.path.join(model_dir, "servable.biscuit")
        assert serve.is_servable_artifact(path)

    def test_rejects_foreign_file(self, tmp_path):
        p = tmp_path / "nope.biscuit"
        p.write_bytes(b"not a servable at all")
        with pytest.raises(ValueError, match="not a biscuit servable"):
            serve.load_servable(str(p), device="cpu")

    def test_rejects_truncated_artifact(self, env, tmp_path):
        _, _, arts = env
        blob = open(arts[0.5, "ops"], "rb").read()
        p = tmp_path / "cut.biscuit"
        p.write_bytes(blob[:-1000])
        with pytest.raises(ValueError, match="truncated or corrupt"):
            serve.load_servable(str(p), device="cpu")

    def test_rejects_bitrot(self, env, tmp_path):
        _, _, arts = env
        blob = bytearray(open(arts[0.5, "ops"], "rb").read())
        blob[-5000] ^= 0x10
        p = tmp_path / "rot.biscuit"
        p.write_bytes(bytes(blob))
        with pytest.raises(ValueError, match="checksum mismatch"):
            serve.load_servable(str(p), device="cpu")

    def test_is_servable_artifact_sniffs_magic(self, env, tmp_path):
        _, dirs, arts = env
        renamed = tmp_path / "model_v3.bin"
        shutil.copy(arts[0.5, "ops"], renamed)
        assert serve.is_servable_artifact(str(renamed))
        assert serve.load_servable(str(renamed), device="cpu").k == 4
        assert not serve.is_servable_artifact(dirs[0.5])
        assert not serve.is_servable_artifact(str(tmp_path / "missing"))
        other = tmp_path / "x.biscuit"
        other.write_bytes(b"PK\x03\x04")
        assert not serve.is_servable_artifact(str(other))

    def _rewrite_header(self, src, dst, **changes):
        blob = open(src, "rb").read()
        n0 = len(serve._MAGIC)
        n = int.from_bytes(blob[n0:n0 + 8], "little")
        header = json.loads(blob[n0 + 8:n0 + 8 + n])
        header.update(changes)
        hdr = json.dumps(header).encode()
        with open(dst, "wb") as f:
            f.write(blob[:n0] + len(hdr).to_bytes(8, "little") + hdr
                    + blob[n0 + 8 + n:])
        return dst

    def test_rejects_future_format(self, env, tmp_path):
        _, _, arts = env
        p = self._rewrite_header(arts[0.5, "ops"], tmp_path / "f.biscuit",
                                 format_version="torch-2")
        with pytest.raises(ValueError, match="not supported"):
            serve.load_servable(str(p), device="cpu")

    def test_device_outside_platforms_raises(self, env):
        _, _, arts = env
        with pytest.raises(ValueError, match="runs on"):
            serve.load_servable(arts[0.5, "ops"], device="cuda")

    def test_each_package_refuses_the_others_artifact(self, env,
                                                      jax_artifact):
        _, _, arts = env
        with pytest.raises(ValueError, match="JAX package"):
            serve.load_servable(jax_artifact, device="cpu")
        with pytest.raises(ValueError, match="not supported"):
            jax_serve.load_servable(arts[0.5, "ops"])


class TestNumerics:
    @pytest.mark.parametrize("route", ["ops", "portable"])
    def test_equals_the_plain_route(self, env, loaded, route):
        sv = loaded(0.5, route)
        tiles = _tiles(BATCH)
        for seed in (3, (1 << 63) | 17):
            got = sv.call_exact(tiles, seed=seed)
            want = _by_hand(env[1][0.5], tiles, seed, route)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert float(got[1].mean()) > 0

    def test_probs_are_probs(self, env):
        _, _, arts = env
        mean, std = serve.load_servable(arts[0.5, "ops"], device="cpu")(
            _tiles(BATCH))
        assert mean.shape == std.shape == (BATCH, 2)
        torch.testing.assert_close(mean.sum(-1), torch.ones(BATCH))
        assert bool((std >= 0).all())

    @pytest.mark.parametrize("route", ["ops", "portable"])
    def test_explicit_seed_is_deterministic(self, loaded, route):
        sv = loaded(0.5, route)
        tiles = _tiles(BATCH)
        a = sv.call_exact(tiles, seed=11)
        b = sv.call_exact(tiles, seed=11)
        c = sv.call_exact(tiles, seed=12)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])

    def test_internal_stream_advances(self, env):
        _, _, arts = env
        tiles = _tiles(BATCH)
        sv = serve.load_servable(arts[0.5, "ops"], device="cpu")
        first, second = sv(tiles), sv(tiles)
        assert not torch.equal(first[0], second[0])
        # The stream is (0 << 32) | calls, and a fresh process repeats it.
        again = serve.load_servable(arts[0.5, "ops"], device="cpu")
        assert torch.equal(again(tiles)[0], first[0])
        assert torch.equal(sv.call_exact(tiles, seed=1)[0], second[0])

    @pytest.mark.parametrize("route", ["ops", "portable"])
    def test_parity_with_the_jax_servable_at_dropout_0(self, loaded,
                                                       jax_artifact, route):
        tiles = _tiles(BATCH, seed=4)
        want_m, want_s = jax_serve.load_servable(jax_artifact).call_exact(
            tiles, key=jax.random.PRNGKey(0))
        want_m = np.asarray(want_m)
        assert np.ptp(want_m[:, 0]) > 2e-2      # predictions vary by tile
        mean, std = loaded(0.0, route).call_exact(tiles, seed=0)
        np.testing.assert_allclose(mean.numpy(), want_m, rtol=0, atol=2e-3)
        np.testing.assert_allclose(std.numpy(), np.asarray(want_s), rtol=0,
                                   atol=1e-6)

    def test_heads_the_kernel_cannot_take_draw_from_the_stream(self,
                                                               tmp_path):
        """A one-hidden-layer head runs the module head's arithmetic with
        Philox masks, layer 0 of the stream: the artifact equals
        ``mc_dropout_head_philox``, which at dropout 0 equals the module
        head."""
        model_dir = _save(tmp_path, 0.5, layers=1)
        path = serve.export_servable(model_dir, str(tmp_path / "h1"),
                                     batch_size=BATCH, use_kernels=True,
                                     device="cpu", with_features=False)
        tiles = _tiles(BATCH)
        got = serve.load_servable(path, device="cpu").call_exact(tiles,
                                                                 seed=9)
        model, hp, _ = load_checkpoint(model_dir, "cpu")
        with torch.no_grad():
            x = fused_preprocess(torch.from_numpy(tiles),
                                 make_normalizer(hp.normalizer))
            feats = trunk_features(model, x, fused_trunk=True)
            want = mc_dropout_head_philox(model, feats, seed_tensor(9), 4)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
            h = torch.relu(model.head.hidden0(feats))
            keep = philox_dropout_bits(9, 4, 0, BATCH, 32) >= (1 << 31)
            probs = torch.softmax(model.head.logits(
                torch.where(keep, h / 0.5, torch.zeros_like(h))), -1)
            torch.testing.assert_close(got[0], probs.mean(0), rtol=0,
                                       atol=1e-6)
            model.head.dropout = 0.0
            m0, s0 = mc_dropout_head_philox(model, feats, 9, 4)
            torch.testing.assert_close(
                m0, torch.softmax(model.head(feats), -1), rtol=0, atol=0)
            assert float(s0.abs().max()) == 0.0


class TestSeeds:
    SEEDS = (0, 5, (7 << 32) | 3, (1 << 31) << 32 | 2, (1 << 63) + 12345,
             (1 << 64) - 1)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_tensor_seed_draws_equal_int_seed_draws(self, seed):
        t = seed_tensor(seed)
        assert t.dtype == torch.int64 and t.ndim == 0 and not t.is_cuda
        assert int(t) & ((1 << 64) - 1) == seed
        assert torch.equal(philox_dropout_bits(t, 3, 1, 5, 12),
                           philox_dropout_bits(seed, 3, 1, 5, 12))

    def test_head_plain_version_takes_either_seed(self):
        g = torch.Generator().manual_seed(0)
        feats = torch.randn(4, 16, generator=g)
        w = [torch.randn(16, 16, generator=g) * 0.3, torch.zeros(16),
             torch.randn(16, 16, generator=g) * 0.3, torch.zeros(16),
             torch.randn(16, 2, generator=g) * 0.3, torch.zeros(2)]
        w = [t.to(torch.bfloat16) if t.ndim == 2 else t for t in w]
        seed = (1 << 63) | 99
        a = mcd_head_reference(feats, *w, k=5, dropout=0.3, seed=seed)
        b = mcd_head_reference(feats, *w, k=5, dropout=0.3,
                               seed=seed_tensor(seed))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


class TestPadding:
    @pytest.fixture(scope="class")
    def sv(self, loaded):
        return loaded(0.5, "ops")

    def test_partial_batch(self, sv):
        tiles = _tiles(5)
        mean, std = sv(tiles, seed=2)
        assert mean.shape == std.shape == (5, 2)
        padded = np.concatenate([tiles, np.zeros((3, PX, PX, 3), np.uint8)])
        want = sv.call_exact(padded, seed=2)
        torch.testing.assert_close(mean, want[0][:5], rtol=0, atol=0)

    def test_chunking_beyond_batch(self, sv):
        tiles = _tiles(19)
        mean, _ = sv(tiles, seed=2)
        assert mean.shape == (19, 2)
        torch.testing.assert_close(mean[:8], sv.call_exact(
            tiles[:8], seed=2)[0], rtol=0, atol=0)

    def test_single_tile_rank3(self, sv):
        mean, std = sv(_tiles(1)[0], seed=2)
        assert mean.shape == std.shape == (1, 2)

    def test_empty_batch(self, sv):
        mean, std = sv(np.zeros((0, PX, PX, 3), np.uint8))
        assert mean.shape == std.shape == (0, 2)

    def test_call_exact_wants_the_exported_batch(self, sv):
        with pytest.raises(ValueError, match="use __call__"):
            sv.call_exact(_tiles(3))


class TestFeatures:
    @pytest.mark.parametrize("route", ["ops", "portable"])
    def test_equals_the_live_feature_path(self, env, loaded, route):
        _, dirs, _ = env
        sv = loaded(0.5, route)
        tiles = _tiles(BATCH, seed=2)
        got = sv.features_exact(tiles, seed=6)
        want = _by_hand(dirs[0.5], tiles, 6, route, k=8, features=True)
        assert got[0].shape == (BATCH, 128)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        # The trunk is deterministic: the UQ program sees the same features.
        torch.testing.assert_close(
            sv.call_exact(tiles, seed=6)[0],
            _by_hand(dirs[0.5], tiles, 6, route)[0], rtol=0, atol=0)

    def test_any_n_contract(self, loaded):
        sv = loaded(0.5, "ops")
        feats, mean, std = sv.features(_tiles(11))
        assert feats.shape == (11, 128) and mean.shape == std.shape == (11, 2)

    def test_generate_features_from_the_artifact(self, env, corpus):
        _, _, arts = env
        paths, _ = corpus
        sv = serve.load_servable(arts[0.5, "ops"], device="cpu")
        feats, meta, tiles = generate_features(sv, paths, max_tiles=5,
                                               keep_tiles=True, k=3)
        assert feats.shape == (15, 128) and tiles.shape == (15, PX, PX, 3)
        # Batch b draws from seed b, as generate_features' live path.
        want = sv.features_exact(tiles[:BATCH], seed=0)
        np.testing.assert_array_equal(feats[:BATCH], want[0].numpy())
        np.testing.assert_array_equal(
            np.stack([m["probs"] for m in meta[:BATCH]]), want[1].numpy())
        by_path = generate_features(arts[0.5, "ops"], paths, max_tiles=5,
                                    device="cpu")[0]
        np.testing.assert_array_equal(by_path, feats)

    def test_featureless_artifact_raises(self, env, loaded, corpus):
        _, _, arts = env
        with pytest.raises(ValueError, match="with_features=True"):
            generate_features(arts[0.0, "portable"], corpus[0],
                              device="cpu")
        sv = loaded(0.0, "portable")
        with pytest.raises(ValueError, match="with_features=True"):
            sv.features(_tiles(2))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three slides of 7 PNG tiles each in tfrecords."""
    root = tmp_path_factory.mktemp("predict_corpus")
    tiles = {}
    for i in range(3):
        slide = f"sl{i}"
        tiles[slide] = _tiles(7, seed=10 + i)
        with TFRecordWriter(str(root / f"{slide}.tfrecords")) as w:
            for t in range(7):
                w.write_tile(slide, encode_png(tiles[slide][t]), loc_x=t,
                             loc_y=2 * t)
    return sorted(str(p) for p in root.glob("*.tfrecords")), tiles


class TestPredict:
    def test_frame_contract_and_rows(self, loaded, corpus):
        paths, tiles = corpus
        sv = loaded(0.5, "ops")
        df = serve.predict_tfrecords(sv, paths, labels={"sl0": 0, "sl1": 1},
                                     seed=3)
        assert list(df.columns) == [
            "slide", "loc_x", "loc_y", "cohort_y_true0", "cohort_y_pred0",
            "cohort_y_pred1", "cohort_uncertainty0", "cohort_uncertainty1"]
        assert len(df) == 21
        assert set(df[df.slide == "sl2"].cohort_y_true0) == {-1}
        assert set(df[df.slide == "sl1"].cohort_y_true0) == {1}
        assert sorted(df[df.slide == "sl1"].loc_y) == [2 * t for t in range(7)]
        # Batch 1 is sl1's last 6 tiles and sl2's first 2, seed (3 << 32) | 1.
        second = np.concatenate([tiles["sl1"][1:], tiles["sl2"][:2]])
        want, _ = sv.call_exact(second, seed=(3 << 32) | 1)
        np.testing.assert_array_equal(df.cohort_y_pred1.to_numpy()[8:16],
                                      want[:, 1].numpy())

    def test_cli(self, env, corpus, tmp_path):
        _, _, arts = env
        paths, _ = corpus
        ann = str(tmp_path / "ann.csv")
        pd.DataFrame({"slide": ["sl0", "sl1", "sl2"],
                      "cohort": ["LUAD", "LUSC", "LUAD"]}).to_csv(ann,
                                                                 index=False)
        outs = []
        for i in range(2):
            outs.append(str(tmp_path / f"p{i}.csv"))
            r = CliRunner().invoke(predict_cli, [
                arts[0.5, "ops"], os.path.dirname(paths[0]), "-o", outs[-1],
                "--annotations", ann, "--seed", "1", "--device", "cpu"])
            assert r.exit_code == 0, r.output
            assert r.output.strip().endswith(outs[-1])
        df = pd.read_csv(outs[0])
        assert len(df) == 21
        assert set(df[df.slide == "sl0"].cohort_y_true0) == {0}
        assert set(df[df.slide == "sl1"].cohort_y_true0) == {1}
        pd.testing.assert_frame_equal(df, pd.read_csv(outs[1]))

    def test_cli_numeric_slide_ids_join_as_strings(self, env, tmp_path):
        _, _, arts = env
        tfr = tmp_path / "numeric"
        tfr.mkdir()
        for sl in ("0123", "7"):
            with TFRecordWriter(str(tfr / f"{sl}.tfrecords")) as w:
                w.write_tile(sl, encode_png(_tiles(1)[0]), loc_x=0, loc_y=0)
        ann = str(tmp_path / "num_ann.csv")
        # Codes 2 and 10 sort as strings: "10" -> 0, "2" -> 1.
        pd.DataFrame({"slide": ["0123", "7"], "cohort": ["2", "10"]}
                     ).to_csv(ann, index=False)
        out = str(tmp_path / "num_preds.csv")
        r = CliRunner().invoke(predict_cli, [
            arts[0.5, "ops"], str(tfr), "-o", out, "--annotations", ann,
            "--device", "cpu"])
        assert r.exit_code == 0, r.output
        df = pd.read_csv(out, dtype={"slide": str})
        assert set(df[df.slide == "0123"].cohort_y_true0) == {1}
        assert set(df[df.slide == "7"].cohort_y_true0) == {0}

    def test_cli_label_order_guards(self, env, corpus, tmp_path):
        _, _, arts = env
        root = os.path.dirname(corpus[0][0])
        ann = str(tmp_path / "one_class.csv")
        pd.DataFrame({"slide": ["sl0", "sl1", "sl2"],
                      "cohort": ["LUSC"] * 3}).to_csv(ann, index=False)
        out = str(tmp_path / "p.csv")
        base = [arts[0.5, "ops"], root, "-o", out, "--annotations", ann,
                "--device", "cpu"]
        r = CliRunner().invoke(predict_cli, base)
        assert r.exit_code != 0 and "only one outcome value" in r.output
        r = CliRunner().invoke(predict_cli, base + ["--classes", "LUAD,LUSC"])
        assert r.exit_code == 0, r.output
        assert set(pd.read_csv(out).cohort_y_true0) == {1}
        r = CliRunner().invoke(predict_cli,
                               base + ["--classes", "ADENO,SQUAM"])
        assert r.exit_code != 0
        assert "not in the training class order" in r.output

    def test_artifact_outcome_labels_pin_order(self, corpus, tmp_path):
        model_dir = _save(tmp_path, 0.0, outcome_labels=["LUAD", "LUSC"])
        art = serve.export_servable(model_dir, batch_size=BATCH,
                                    use_kernels=True, device="cpu",
                                    with_features=False)
        assert serve.load_servable(art, device="cpu").header[
            "outcome_labels"] == ["LUAD", "LUSC"]
        ann = str(tmp_path / "one_class.csv")
        pd.DataFrame({"slide": ["sl0", "sl1", "sl2"],
                      "cohort": ["LUSC"] * 3}).to_csv(ann, index=False)
        out = str(tmp_path / "p.csv")
        r = CliRunner().invoke(predict_cli, [
            art, os.path.dirname(corpus[0][0]), "-o", out, "--annotations",
            ann, "--device", "cpu"])
        assert r.exit_code == 0, r.output
        assert set(pd.read_csv(out).cohort_y_true0) == {1}

    @pytest.mark.parametrize("flag", [["--sharded"],
                                      ["--distributed", "workdir"]])
    def test_cli_multi_device_flags_raise_naming_item_9(self, env, corpus,
                                                         flag):
        r = CliRunner().invoke(predict_cli, [
            env[2][0.5, "ops"], corpus[0][0], "--device", "cpu", *flag])
        assert isinstance(r.exception, NotImplementedError)
        assert "Queue 1 item 9" in str(r.exception)

    @pytest.mark.parametrize("name", [
        "ShardedServable", "load_sharded_servable",
        "predict_tfrecords_distributed", "predict_slides_distributed"])
    def test_multi_device_entry_points_raise_naming_item_9(self, name):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            getattr(serve, name)("artifact.biscuit", [], "workdir")


class TestPredictSlides:
    @pytest.fixture(scope="class")
    def slide(self, tmp_path_factory):
        """White background with noisy pink tissue blobs, 256 px."""
        rng = np.random.default_rng(0)
        img = np.full((256, 256, 3), 245, np.uint8)
        yy, xx = np.mgrid[0:256, 0:256]
        for _ in range(6):
            cy, cx = rng.integers(40, 216, 2)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(25, 50) ** 2
            img[m] = np.clip(np.array([170, 90, 140]) + rng.normal(
                0, 25, (int(m.sum()), 3)), 0, 255).astype(np.uint8)
        p = str(tmp_path_factory.mktemp("wsi") / "slideA.png")
        Image.fromarray(img).save(p)
        return p

    def test_matches_by_hand_generator(self, loaded, slide):
        sv = loaded(0.5, "ops")
        df = serve.predict_slides(sv, [slide], mpp=1.0, qc=None, seed=13)
        assert len(df) == 64                    # an 8 x 8 grid, no QC
        assert (df.cohort_y_true0 == -1).all()
        assert df.slide.unique().tolist() == ["slideA"]
        gen = WSI(slide, tile_px=PX, tile_um=PX, mpp=1.0).build_generator(
            include_loc="grid")
        items = list(gen())
        want, _ = sv.call_exact(np.stack([t["image"] for t in items[:BATCH]]),
                                seed=13 << 32)
        np.testing.assert_array_equal(df.cohort_y_pred1.to_numpy()[:BATCH],
                                      want[:, 1].numpy())
        assert [tuple(t["loc"]) for t in items] == list(zip(df.loc_x,
                                                            df.loc_y))

    def test_qc_drops_background(self, loaded, slide):
        sv = loaded(0.5, "ops")
        assert 0 < len(serve.predict_slides(sv, [slide], mpp=1.0,
                                            qc="both")) < 64

    def test_max_tiles_caps_per_slide(self, loaded, slide):
        sv = loaded(0.5, "ops")
        df = serve.predict_slides(sv, [slide, slide], mpp=1.0, qc=None,
                                  max_tiles=5)
        assert len(df) == 10

    def test_cli_slides_mode(self, env, slide, tmp_path):
        out = str(tmp_path / "wsi_preds.csv")
        r = CliRunner().invoke(predict_cli, [
            env[2][0.5, "ops"], slide, "--slides", "--mpp", "1.0", "--qc",
            "none", "-o", out, "--device", "cpu"])
        assert r.exit_code == 0, r.output
        df = pd.read_csv(out)
        assert len(df) == 64 and np.isfinite(df.cohort_y_pred1).all()


class TestExportCLI:
    def test_cli_exports_and_prints_path(self, env, tmp_path):
        _, dirs, _ = env
        out = str(tmp_path / "cli.biscuit")
        r = CliRunner().invoke(export_cli, [
            dirs[0.0], "-o", out, "-b", "4", "--no-features", "--fused",
            "--device", "cpu"])
        assert r.exit_code == 0, r.output
        assert r.output.strip().splitlines()[-1] == out
        sv = serve.load_servable(out, device="cpu")
        assert sv.batch_size == 4 and not sv.has_features
        assert sv.header["use_kernels"] is True

    @pytest.mark.parametrize("args", [
        ["--fused", "--platform", "cpu", "--platform", "cuda"],
        ["--fused", "--platform", "cuda"]])
    def test_cli_refuses_a_platform_the_kernels_cannot_serve(self, env,
                                                             args):
        r = CliRunner().invoke(export_cli, [
            env[1][0.0], "-o", "unused", "--device", "cpu", *args])
        assert isinstance(r.exception, ValueError)
        assert "use_kernels=False" in str(r.exception)

    def test_portable_lists_both_platforms(self, env, tmp_path):
        path = serve.export_servable(
            env[1][0.0], str(tmp_path / "both.biscuit"), batch_size=2,
            use_kernels=False, platforms=["cuda", "cpu"], device="cpu",
            with_features=False)
        sv = serve.load_servable(path, device="cpu")
        assert sv.platforms == ("cuda", "cpu") and sv.device.type == "cpu"

    def test_fuse_blocks_needs_the_kernels(self, env):
        with pytest.raises(ValueError, match="use_kernels=False"):
            serve.export_servable(env[1][0.0], "unused", use_kernels=False,
                                  fuse_blocks=True, device="cpu")


def _block_args(g):
    bf = torch.bfloat16
    cin, f0, f1 = 8, 16, 16

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g) * s

    w = [r(9, cin), r(cin, f0, s=0.3).to(bf), r(f0).abs() + .5, r(f0, s=.1),
         r(9, f0), r(f0, f1, s=0.3).to(bf), r(f1).abs() + .5, r(f1, s=.1),
         r(cin, f1, s=0.3).to(bf), r(f1).abs() + .5, r(f1, s=.1)]
    return r(2, 7, 7, cin).to(bf), w, 1


def _op_args(name):
    g = torch.Generator().manual_seed(0)
    if name == "fused_preprocess":
        x = torch.randint(0, 256, (2, 9, 9, 3), dtype=torch.uint8,
                          generator=g)
        return x, coefficients(ReinhardFastNormalizer(), "cpu")
    if name == "fused_middle_flow":
        u, c = 3, 16
        return (torch.randn(2, 5, 5, c, generator=g).to(torch.bfloat16),
                torch.randn(u, 9, c, generator=g),
                (torch.randn(u, c, c, generator=g) * 0.1).to(torch.bfloat16),
                torch.rand(u, c, generator=g) + 0.5,
                torch.randn(u, c, generator=g) * 0.1)
    if name == "fused_strided_block":
        return _block_args(g)
    head = Head(16, 2, 2, 16, 0.25)
    return (torch.randn(3, 16, generator=g), list(head_weights(head)),
            seed_tensor((1 << 63) + 5), 4, 0.25)


@pytest.mark.parametrize("name", ["fused_preprocess", "fused_middle_flow",
                                  "fused_strided_block", "mcd_head"])
def test_opcheck(name):
    """Schema, fake tensors, autograd registration and AOT dispatch of the
    registered op (on the CPU its plain version runs)."""
    torch.library.opcheck(getattr(library, name), _op_args(name))
