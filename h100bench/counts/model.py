"""FLOPs a tile of a configuration (its ``counts`` module names the trunk's
family): one serving request's tile is one trunk pass and K head passes,
one training step's tile three times the forward of the trunk and one
head pass (a data and a weight gradient of every conv and matmul). The
arithmetic of ``biscuit_torch/models/flops.py`` ``uq_flops_per_tile`` and
``train_flops_per_tile``."""

import importlib


def head_flops(feature_dim: int, hidden: int, hidden_layers: int,
               num_classes: int) -> int:
    f = 2 * feature_dim * hidden
    f += 2 * hidden * hidden * (hidden_layers - 1)
    f += 2 * hidden * num_classes
    return f


def _family(config: dict):
    return importlib.import_module(f"h100bench.counts.{config['counts']}")


def _head(config: dict, fam) -> int:
    hp = config["hp"]
    return head_flops(fam.feature_dim(config["arch"]),
                      hp["hidden_layer_width"], hp["hidden_layers"],
                      config["classes"])


def serve_flops_per_tile(config: dict) -> int:
    fam = _family(config)
    return (fam.trunk_flops(config["arch"], config["hp"]["tile_px"])
            + config["hp"]["uq_samples"] * _head(config, fam))


def train_flops_per_tile(config: dict) -> int:
    fam = _family(config)
    return 3 * (fam.trunk_flops(config["arch"], config["hp"]["tile_px"])
                + _head(config, fam))
