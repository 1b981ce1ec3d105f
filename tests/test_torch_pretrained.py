"""The port's Keras import (biscuit_torch/models/pretrained.py, the
import CLI and ``hp.pretrained`` in ``init_model``) against the JAX
package's converter and the independent numpy Keras graph of
tests/test_keras_numpy_forward.py.

Tolerances: the converted trees are compared exactly (same numpy
arithmetic, the BN-eps shift included); a Keras -> tree -> Keras round
trip is exact except ``moving_variance``, within one f32 ulp of the eps
shift and back; features against the numpy graph within 1e-4 in f32, as
the JAX test holds its own.
"""

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from flax.core import unfreeze
from test_import_model import head_forward, make_head_weights
from test_keras_numpy_forward import (
    _write_npz,
    make_keras_weights,
    xception_forward,
)
from test_pretrained import _write_h5

from biscuit_torch.hp import ModelParams
from biscuit_torch.models import pretrained as port
from biscuit_torch.models.convert import read_msgpack, to_flax
from biscuit_torch.models.xception import ARCHS, build_model
from biscuit_torch.train.trainer import init_model
from biscuit_tpu.models import pretrained as ref

torch.set_num_threads(1)

CFG = ARCHS["xception_tiny"]


def _hp(**kw):
    base = dict(model="xception_tiny", tile_px=32, hidden_layers=1,
                hidden_layer_width=16, dropout=0.0, compute_dtype="float32")
    base.update(kw)
    return ModelParams(**base)


def _model(seed=0, **kw):
    hp = _hp(**kw)
    return init_model(build_model(hp), hp,
                      torch.Generator().manual_seed(seed)).eval(), hp


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _to_keras(params, stats, arch="xception_tiny"):
    """Inverse of convert_keras_xception: the model's trees -> Keras
    layers (tests/test_pretrained.py's inverse, on the port's map)."""
    out = {}
    for path, (name, kind) in port.keras_layer_map(arch).items():
        p = params["backbone"]
        for k in path:
            p = p[k]
        if kind == "conv":
            out[name] = {"kernel": p["kernel"]}
        elif kind == "sepconv":
            out[name] = {
                "depthwise_kernel": p["depthwise"]["kernel"].transpose(
                    0, 1, 3, 2),
                "pointwise_kernel": p["pointwise"]["kernel"]}
        else:
            s = stats["backbone"]
            for k in path:
                s = s[k]
            out[name] = {"gamma": p["scale"], "beta": p["bias"],
                         "moving_mean": s["mean"],
                         "moving_variance": s["var"] - (
                             port._KERAS_BN_EPS - port._FLAX_BN_EPS)}
    return out


@pytest.fixture(scope="module")
def keras_file(tmp_path_factory):
    """A tiny-arch Keras trunk file (.npz and .h5) with its numpy-graph
    features on a fixed input."""
    rng = np.random.default_rng(7)
    w = make_keras_weights(CFG, rng)
    tmp = tmp_path_factory.mktemp("keras")
    _write_npz(str(tmp / "w.npz"), w)
    _write_h5(str(tmp / "w.h5"), w)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return tmp, w, x, xception_forward(x, w, CFG)


@pytest.fixture(scope="module")
def full_file(tmp_path_factory):
    """A full tiny export (trunk, 1x16 head, 2-class logits) and its
    numpy-graph logits (tests/test_import_model.py's fixture)."""
    rng = np.random.default_rng(11)
    w = make_keras_weights(CFG, rng)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    feats = xception_forward(x, w, CFG)
    w.update(make_head_weights(feats.shape[1], [16], 2, rng))
    path = str(tmp_path_factory.mktemp("full") / "full.npz")
    _write_npz(path, w)
    return path, x, head_forward(feats, w, n_hidden=1)


def test_full_xception_layer_inventory():
    m = port.keras_layer_map("xception")
    names = [v[0] for v in m.values()]
    assert len(names) == len(set(names)) == 80
    assert m == ref.keras_layer_map("xception")
    assert port.keras_layer_map("xception_tiny") == ref.keras_layer_map(
        "xception_tiny")
    with pytest.raises(ValueError, match="only defined for Xception"):
        port.keras_layer_map("resnet50")


@pytest.mark.parametrize("ext", ["npz", "h5"])
def test_round_trip(tmp_path, ext):
    """Trees -> Keras file -> converter onto another seed's templates
    gives the trees back."""
    src, _ = _model(seed=1)
    params, stats = to_flax(src.state_dict())
    path = str(tmp_path / f"w.{ext}")
    (_write_npz if ext == "npz" else _write_h5)(path,
                                                _to_keras(params, stats))
    other, _ = _model(seed=2)
    got_p, got_s = port.convert_keras_xception(
        port.read_keras_weights(path), *to_flax(other.state_dict()),
        arch="xception_tiny")
    _assert_trees_equal(got_p["backbone"], params["backbone"])
    _assert_trees_equal(got_p["head"], to_flax(other.state_dict())[0]["head"])
    for key, want in _leaves(stats):
        got = dict(_leaves(got_s))[key]
        if key[-1] == "var":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want)


def test_h5_without_layer_names_keeps_graph_order(tmp_path):
    """h5py lists groups alphabetically ('dense_10' before 'dense_2');
    the natural sort restores Keras's creation order, so a head of ten
    equal-width hidden layers loads in order."""
    import h5py

    rng = np.random.default_rng(3)
    w = make_head_weights(CFG["exit_convs"][-1], [8] * 10, 2, rng)
    path = str(tmp_path / "head.h5")
    with h5py.File(path, "w") as f:
        for layer in sorted(w):
            g = f.create_group(layer)
            for name, a in w[layer].items():
                g.create_dataset(f"{layer}/{name}:0", data=a)
    kw = port.read_keras_weights(path)
    assert list(kw) == ["dense"] + [f"dense_{i}" for i in range(1, 11)]
    model, _ = _model(hidden_layers=10, hidden_layer_width=8)
    params, _stats = to_flax(model.state_dict())
    got = port.convert_keras_head(kw, params)["head"]
    for i in range(11):
        name = "logits" if i == 10 else f"hidden{i}"
        keras = "dense" if i == 0 else f"dense_{i}"
        np.testing.assert_array_equal(got[name]["kernel"],
                                      w[keras]["kernel"])
        np.testing.assert_array_equal(got[name]["bias"], w[keras]["bias"])
    assert kw.keys() == ref.read_keras_weights(path).keys()


def test_problems_are_listed(keras_file):
    _tmp, w, _x, _f = keras_file
    bad = {k: dict(v) for k, v in w.items() if k != "block2_sepconv1_bn"}
    bad["block1_conv1"]["kernel"] = bad["block1_conv1"]["kernel"][..., :2]
    model, _ = _model()
    with pytest.raises(ValueError) as got:
        port.convert_keras_xception(bad, *to_flax(model.state_dict()),
                                    arch="xception_tiny")
    msg = str(got.value)
    assert "(2 problems)" in msg
    assert "missing Keras layer 'block2_sepconv1_bn'" in msg
    assert "shape mismatch at conv1/kernel (from 'block1_conv1')" in msg


def test_resolve_pretrained_path(tmp_path, monkeypatch):
    monkeypatch.setenv("BISCUIT_PRETRAINED_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no staged weights"):
        port.resolve_pretrained_path("imagenet")
    (tmp_path / "xception_imagenet.npz").write_bytes(b"")
    assert port.resolve_pretrained_path("imagenet") == str(
        tmp_path / "xception_imagenet.npz")
    (tmp_path / "xception_imagenet.h5").write_bytes(b"")
    assert port.resolve_pretrained_path("imagenet") == str(
        tmp_path / "xception_imagenet.h5")
    assert port.resolve_pretrained_path(str(tmp_path / "xception_imagenet"
                                            ".npz")).endswith(".npz")
    with pytest.raises(FileNotFoundError, match="not found"):
        port.resolve_pretrained_path(str(tmp_path / "nope.h5"))


@pytest.mark.parametrize("ext", ["npz", "h5"])
def test_tree_equals_the_jax_converter(keras_file, ext):
    from biscuit_tpu.hp import ModelParams as JaxParams
    from biscuit_tpu.models.xception import build_model as jax_build
    from biscuit_tpu.train.trainer import init_model as jax_init

    tmp = keras_file[0]
    path = str(tmp / f"w.{ext}")
    jhp = JaxParams(**_hp().to_dict())
    jp, js = jax_init(jax_build(jhp), jhp, jax.random.PRNGKey(0))
    want_p, want_s = ref.load_pretrained(jp, js, path, arch="xception_tiny")
    model, _ = _model()
    got_p, got_s = port.convert_keras_xception(
        port.read_keras_weights(path), *to_flax(model.state_dict()),
        arch="xception_tiny")
    np_tree = jax.tree_util.tree_map(np.asarray, unfreeze(want_p))
    _assert_trees_equal(got_p["backbone"], np_tree["backbone"])
    _assert_trees_equal(got_s["backbone"], jax.tree_util.tree_map(
        np.asarray, unfreeze(want_s))["backbone"])


def test_features_match_numpy_keras(keras_file):
    tmp, _w, x, want = keras_file
    model, _ = _model()
    port.load_pretrained(model, str(tmp / "w.npz"))
    with torch.no_grad():
        got = model.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_full_import_logits_and_head_count(full_file):
    path, x, want = full_file
    model, _ = _model()
    port.load_pretrained_full(model, path)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    two, _ = _model(hidden_layers=2)
    with pytest.raises(ValueError, match="has 2 Dense layers"):
        port.load_pretrained_full(two, path)


def test_pretrained_grafts_the_trunk_in_init_model(keras_file, tmp_path,
                                                   monkeypatch):
    import shutil

    tmp, w, _x, _f = keras_file
    shutil.copy(tmp / "w.npz", tmp_path / "xception_imagenet.npz")
    monkeypatch.setenv("BISCUIT_PRETRAINED_DIR", str(tmp_path))
    fresh, hp = _model(seed=5)
    staged, _ = _model(seed=5, pretrained="imagenet")
    params, stats = to_flax(staged.state_dict())
    want_p, want_s = port.convert_keras_xception(
        port.read_keras_weights(str(tmp / "w.npz")),
        *to_flax(fresh.state_dict()), arch="xception_tiny")
    _assert_trees_equal(params, want_p)
    _assert_trees_equal(stats, want_s)
    np.testing.assert_array_equal(
        params["backbone"]["conv1"]["kernel"], w["block1_conv1"]["kernel"])
    # The head keeps the fresh init of the same generator.
    _assert_trees_equal(params["head"], to_flax(fresh.state_dict())[0]["head"])


def test_import_clis_agree(full_file, tmp_path):
    """Both import CLIs on one file write equal arrays, and the JAX
    package's load_checkpoint reads the port's model dir."""
    from biscuit_torch.cli.import_model import main as port_main
    from biscuit_tpu.cli.import_model import main as jax_main
    from biscuit_tpu.train.trainer import load_checkpoint

    path = full_file[0]
    args = ["--arch", "xception_tiny", "--tile-px", "32", "--tile-um", "32",
            "--hidden-layers", "1", "--hidden-width", "16",
            "--normalizer", "none", "--uq-samples", "4"]
    dirs = []
    for main, name in ((port_main, "port"), (jax_main, "jax")):
        r = CliRunner().invoke(main, [path, str(tmp_path / name), *args])
        assert r.exit_code == 0, r.output
        dirs.append(r.output.strip().splitlines()[-1])
    got, ref_tree = (read_msgpack(f"{d}/model.msgpack") for d in dirs)
    _assert_trees_equal(got, ref_tree)

    _model_, params, stats, hp, _meta = load_checkpoint(dirs[0])
    assert hp.uq and hp.uq_samples == 4 and hp.pretrained is None
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, {"params": unfreeze(params),
                                            "batch_stats": unfreeze(stats)}),
        got)
