"""Keras Xception weights -> the port's model (ImageNet initialization and
full-model import).

The port's copy of ``biscuit_tpu/models/pretrained.py``, in numpy. The
published model is slideflow's tf.keras Xception initialized from
ImageNet weights (``xception_weights_tf_dim_ordering_tf_kernels_notop.h5``).
Nothing is downloaded: a staged Keras-layout weight file (``.h5`` as
``Model.save_weights`` writes it, or an ``.npz`` of ``'<layer>/<weight>'``
arrays) is mapped onto the Flax-layout numpy tree that
``models/convert.from_flax`` takes, and that tree is loaded into the
model. So there is one weight bridge, and the tree equals the JAX
converter's leaf for leaf.

Staging: put the Keras notop weights at
``$BISCUIT_PRETRAINED_DIR/xception_imagenet.h5`` (or ``.npz``; default dir
``~/.biscuit/pretrained``) and set ``ModelParams(pretrained='imagenet')``,
or give a path as ``pretrained``. ``train/trainer.init_model`` grafts the
trunk only; the head keeps its fresh initialization (``include_top=False``
in the reference). ``load_pretrained_full`` also takes the Dense head of a
full-model export (``cli/import_model.py``).

Layer names (tf.keras.applications.Xception, Keras >= 2.4): named layers
``block1_conv{1,2}[_bn]``, ``block{2..4}_sepconv{1,2}[_bn]``,
``block{5..12}_sepconv{1,2,3}[_bn]``, ``block13_sepconv{1,2}[_bn]``,
``block14_sepconv{1,2}[_bn]``; the four residual-shortcut convs are
unnamed in the Keras source, so they carry creation-order names:
``conv2d``, ``conv2d_1``, ``conv2d_2`` (entry blocks 2-4) and ``conv2d_3``
(block 13), with ``batch_normalization[_N]`` beside them.

Layouts (Keras -> Flax tree): a Conv2D kernel (H, W, I, O) is unchanged;
a SeparableConv2D depthwise kernel (H, W, I, 1) becomes the grouped conv's
(H, W, 1, I); its pointwise kernel (1, 1, I, O) is unchanged; BatchNorm
gamma/beta/moving_mean/moving_variance become scale/bias and mean/var.
Keras Xception's BatchNorm has eps 1e-3, the port's (as Flax's) 1e-5: the
stored variance is shifted by the difference, which is exact at inference
because only var + eps enters the normalization.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .xception import ARCHS

# How a Keras layer's arrays map onto tree leaves.
_CONV = "conv"        # kernel -> kernel
_SEP = "sepconv"      # depthwise_kernel/pointwise_kernel -> two sub-convs
_BN = "bn"            # gamma/beta -> params, moving_* -> batch_stats

_KERAS_BN_EPS = 1e-3
_FLAX_BN_EPS = 1e-5


def keras_layer_map(arch: str = "xception") -> Dict[Tuple[str, ...],
                                                    Tuple[str, str]]:
    """Backbone module path -> (keras_layer_name, kind).

    Generated from ``ARCHS``, so the tiny arch runs the same mapping code.
    For 'xception' the names are exactly the 80 weighted layers of
    ``tf.keras.applications.Xception`` (40 conv/sepconv + 40 batchnorm).
    """
    if arch not in ARCHS:
        raise ValueError(
            f"Pretrained Keras weights are only defined for Xception archs "
            f"({sorted(ARCHS)}), not {arch!r}"
        )
    cfg = ARCHS[arch]
    m: Dict[Tuple[str, ...], Tuple[str, str]] = {
        ("conv1",): ("block1_conv1", _CONV),
        ("conv1_bn",): ("block1_conv1_bn", _BN),
        ("conv2",): ("block1_conv2", _CONV),
        ("conv2_bn",): ("block1_conv2_bn", _BN),
    }

    def auto(i: int, base: str) -> str:
        return base if i == 0 else f"{base}_{i}"

    n_auto = 0  # creation-order counter of the unnamed shortcut convs
    block = 2
    for i in range(len(cfg["entry_blocks"])):
        for j in range(2):
            m[(f"entry{i}", f"sep{j}")] = (f"block{block}_sepconv{j + 1}", _SEP)
            m[(f"entry{i}", f"bn{j}")] = (f"block{block}_sepconv{j + 1}_bn", _BN)
        m[(f"entry{i}", "res_conv")] = (auto(n_auto, "conv2d"), _CONV)
        m[(f"entry{i}", "res_bn")] = (auto(n_auto, "batch_normalization"), _BN)
        n_auto += 1
        block += 1
    for i in range(cfg["middle_repeats"]):
        for j in range(3):
            m[(f"middle{i}", f"sep{j}")] = (f"block{block}_sepconv{j + 1}", _SEP)
            m[(f"middle{i}", f"bn{j}")] = (f"block{block}_sepconv{j + 1}_bn", _BN)
        block += 1
    for j in range(2):
        m[("exit_block", f"sep{j}")] = (f"block{block}_sepconv{j + 1}", _SEP)
        m[("exit_block", f"bn{j}")] = (f"block{block}_sepconv{j + 1}_bn", _BN)
    m[("exit_block", "res_conv")] = (auto(n_auto, "conv2d"), _CONV)
    m[("exit_block", "res_bn")] = (auto(n_auto, "batch_normalization"), _BN)
    block += 1
    for j in range(2):
        m[(f"exit_sep{j}",)] = (f"block{block}_sepconv{j + 1}", _SEP)
        m[(f"exit_bn{j}",)] = (f"block{block}_sepconv{j + 1}_bn", _BN)
    return m


def _strip(name) -> str:
    """'block1_conv1/kernel:0' -> 'kernel' (last path part, no ':0')."""
    if isinstance(name, bytes):
        name = name.decode()
    return name.split("/")[-1].split(":")[0]


def _natural_key(name):
    """Sort key treating digit runs numerically: dense_2 < dense_10."""
    import re

    if isinstance(name, bytes):
        name = name.decode()
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def read_keras_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a Keras-layout weight file into {layer: {weight: array}}.

    Takes the HDF5 layout of ``Model.save_weights`` (root or
    ``model_weights/`` group, a group a layer with a ``weight_names``
    attribute; h5py is imported only here) and a flat ``.npz`` of
    ``'<layer>/<weight>'`` keys.
    """
    if path.endswith(".npz"):
        out: Dict[str, Dict[str, np.ndarray]] = {}
        with np.load(path) as z:
            for key in z.files:
                layer, _, weight = key.partition("/")
                out.setdefault(layer, {})[_strip(weight)] = z[key]
        return out

    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = root.attrs.get("layer_names", None)
        if names is None:
            # Without layer_names h5py yields keys alphabetically, where
            # Keras auto-names break graph order ('dense_10' before
            # 'dense_2'); the head's structural matching needs graph order,
            # which the natural sort restores for auto-named layers.
            names = sorted(root.keys(), key=_natural_key)
        layer_names = [
            n.decode() if isinstance(n, bytes) else n for n in names
        ]
        for layer in layer_names:
            g = root[layer]
            weight_names = g.attrs.get("weight_names", None)
            if weight_names is None:  # walk the group instead
                weight_names = []
                g.visit(lambda n: weight_names.append(n)
                        if isinstance(g[n], h5py.Dataset) else None)
            arrays = {}
            for wn in weight_names:
                wn_s = wn.decode() if isinstance(wn, bytes) else wn
                arrays[_strip(wn_s)] = np.asarray(g[wn_s])
            if arrays:
                out[layer] = arrays
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _take(layer_arrays: dict, keras_name: str, *keys: str) -> list:
    got = []
    for k in keys:
        if k not in layer_arrays:
            raise ValueError(
                f"Keras layer '{keras_name}' is missing weight '{k}' "
                f"(has {sorted(layer_arrays)})"
            )
        got.append(np.asarray(layer_arrays[k]))
    return got


def _assign(tree, path, array, problems, keras_name):
    try:
        template = _get(tree, path)
    except KeyError:
        problems.append(
            f"Flax tree has no leaf {'/'.join(path)} (from '{keras_name}')")
        return
    if tuple(template.shape) != tuple(array.shape):
        problems.append(
            f"shape mismatch at {'/'.join(path)} (from '{keras_name}'): "
            f"Flax {tuple(template.shape)} vs Keras {tuple(array.shape)}")
        return
    _set(tree, path, np.asarray(array, dtype=template.dtype))


def convert_keras_xception(keras_weights, params, batch_stats,
                           arch: str = "xception"):
    """Map Keras Xception weights onto (params, batch_stats), the
    Flax-layout numpy trees of ``models/convert.to_flax`` used as shape
    and dtype templates. Only ``backbone`` is replaced; the head is left
    as it is. Returns new trees; raises ValueError listing every missing
    layer and shape mismatch."""
    params = _copy(params)
    batch_stats = _copy(batch_stats)
    bb_params = params["backbone"]
    bb_stats = batch_stats["backbone"]
    problems = []

    for flax_path, (keras_name, kind) in keras_layer_map(arch).items():
        if keras_name not in keras_weights:
            problems.append(f"missing Keras layer '{keras_name}' "
                            f"(for backbone/{'/'.join(flax_path)})")
            continue
        arrays = keras_weights[keras_name]
        try:
            if kind == _CONV:
                (kernel,) = _take(arrays, keras_name, "kernel")
                _assign(bb_params, flax_path + ("kernel",), kernel, problems,
                        keras_name)
            elif kind == _SEP:
                dw, pw = _take(arrays, keras_name,
                               "depthwise_kernel", "pointwise_kernel")
                # (H, W, I, 1) -> (H, W, 1, I): the grouped-conv layout.
                _assign(bb_params, flax_path + ("depthwise", "kernel"),
                        dw.transpose(0, 1, 3, 2), problems, keras_name)
                _assign(bb_params, flax_path + ("pointwise", "kernel"),
                        pw, problems, keras_name)
            else:  # _BN
                gamma, beta, mean, var = _take(
                    arrays, keras_name,
                    "gamma", "beta", "moving_mean", "moving_variance")
                _assign(bb_params, flax_path + ("scale",), gamma, problems,
                        keras_name)
                _assign(bb_params, flax_path + ("bias",), beta, problems,
                        keras_name)
                _assign(bb_stats, flax_path + ("mean",), mean, problems,
                        keras_name)
                # x / sqrt(var' + 1e-5) == x / sqrt(var + 1e-3) at inference
                # (module docstring).
                _assign(bb_stats, flax_path + ("var",),
                        var + (_KERAS_BN_EPS - _FLAX_BN_EPS), problems,
                        keras_name)
        except ValueError as e:
            problems.append(str(e))

    if problems:
        raise ValueError(
            "Keras->Flax conversion failed "
            f"({len(problems)} problems):\n  " + "\n  ".join(problems)
        )
    return params, batch_stats


def convert_keras_head(keras_weights, params):
    """Map the Dense head of a full Keras model export onto
    ``params['head']`` (``hidden{i}`` + ``logits``), a new tree.

    slideflow's head layer names depend on its version (unnamed Dense
    layers get Keras auto-names), so matching is structural: the file's
    Dense layers (a 2-D ``kernel`` plus a ``bias``), in file order, are
    ``hidden0..hiddenN-1`` then ``logits``, every shape validated against
    the templates, so a wrong width or count fails instead of loading
    sideways.
    """
    dense = [
        (name, arrays) for name, arrays in keras_weights.items()
        if {"kernel", "bias"} <= set(arrays)
        and np.asarray(arrays["kernel"]).ndim == 2
    ]
    params = _copy(params)
    head = params["head"]
    want = [f"hidden{i}" for i in range(len(head) - 1)] + ["logits"]
    if sorted(head) != sorted(want):
        raise ValueError(f"unexpected head modules {sorted(head)} "
                         f"(expected {want})")
    if len(dense) != len(want):
        raise ValueError(
            f"full-model export has {len(dense)} Dense layers "
            f"({[n for n, _ in dense]}) but the head needs {len(want)} "
            f"({want}); check hidden_layers/--hidden-width against the "
            "exported model")
    problems: list = []
    for flax_name, (keras_name, arrays) in zip(want, dense):
        kernel, bias = _take(arrays, keras_name, "kernel", "bias")
        _assign(head, (flax_name, "kernel"), kernel, problems, keras_name)
        _assign(head, (flax_name, "bias"), bias, problems, keras_name)
    if problems:
        raise ValueError(
            "Keras->Flax head conversion failed "
            f"({len(problems)} problems):\n  " + "\n  ".join(problems))
    return params


def resolve_pretrained_path(spec: str) -> str:
    """'imagenet' -> the staged file under $BISCUIT_PRETRAINED_DIR (default
    ~/.biscuit/pretrained); anything else is an explicit path."""
    if spec != "imagenet":
        if not os.path.exists(spec):
            raise FileNotFoundError(
                f"Pretrained weight file not found: {spec}")
        return spec
    stage_dir = os.environ.get(
        "BISCUIT_PRETRAINED_DIR",
        os.path.join(os.path.expanduser("~"), ".biscuit", "pretrained"),
    )
    for ext in ("h5", "npz"):
        p = os.path.join(stage_dir, f"xception_imagenet.{ext}")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        "pretrained='imagenet' but no staged weights found. Download the "
        "Keras notop Xception weights on a machine with egress and stage "
        f"them at {stage_dir}/xception_imagenet.h5 (see README)."
    )


def _graft(model, convert):
    """Load ``convert(params, batch_stats)`` of the model's own trees into
    the model (in place) and return it."""
    from .convert import from_flax, to_flax

    params, stats = convert(*to_flax(model.state_dict()))
    sd = from_flax(params, stats)
    # from_flax starts BatchNorm step counters at 0; keep the model's.
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = value
    model.load_state_dict(sd)
    return model


def load_pretrained(model, path: str):
    """Graft a staged Keras weight file's trunk onto ``model`` (in place);
    the head keeps its weights. Returns the model."""
    kw = read_keras_weights(path)
    return _graft(model, lambda p, s: convert_keras_xception(
        kw, p, s, arch=model.arch))


def load_pretrained_full(model, path: str):
    """Graft a full model export (trunk + hidden head + logits) onto
    ``model`` (in place): the path for users bringing the published
    trained model (or any slideflow lung model) to the port. See
    :func:`convert_keras_head` for the head's matching; the trunk is the
    ImageNet converter's. Returns the model."""
    kw = read_keras_weights(path)

    def convert(p, s):
        p, s = convert_keras_xception(kw, p, s, arch=model.arch)
        return convert_keras_head(kw, p), s

    return _graft(model, convert)
