"""Seeds of every random choice of a run, each derived from ``--seed`` and
a purpose, so that the same seed gives the same weights, tiles, labels,
request seeds, step generators and check sample."""

import numpy as np


def derive(seed: int, purpose: str, bits: int = 63) -> int:
    words = np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1)] + [ord(c) for c in purpose]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & ((1 << bits) - 1)
