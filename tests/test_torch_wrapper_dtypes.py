"""The dtypes of the kernels' wrappers on a CPU tensor, where each runs
its plain version: the preprocess returns ``out_dtype``, the middle flow
and the strided block return x's dtype, in bf16 and in f32 (the types
their kernels take on the card, as the TPU kernels do), and the
registered ops of ``ops/library.py`` give the same dtypes.
"""

import pytest
import torch

from biscuit_torch.ops import library
from biscuit_torch.ops.fused_block import (
    fused_strided_block,
    fused_strided_block_reference,
)
from biscuit_torch.ops.fused_preprocess import (
    fused_preprocess,
    fused_preprocess_reference,
)
from biscuit_torch.ops.fused_sepconv import (
    fused_middle_flow,
    fused_middle_flow_reference,
)

torch.set_num_threads(1)


def _normal(gen, shape, std=1.0):
    return std * torch.randn(shape, generator=gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_wrappers_return_x_dtype_on_the_cpu(dtype):
    gen = torch.Generator().manual_seed(0)
    tiles = torch.randint(0, 256, (2, 9, 7, 3), generator=gen,
                          dtype=torch.uint8)
    got = fused_preprocess(tiles, out_dtype=dtype)
    assert got.dtype == dtype and got.shape == tiles.shape
    assert torch.equal(got, fused_preprocess_reference(tiles,
                                                       out_dtype=dtype))

    u, c = 3, 16
    mid = (_normal(gen, (u, 9, c), 0.15),
           _normal(gen, (u, c, c), 0.25).to(torch.bfloat16),
           0.8 + 0.4 * torch.rand((u, c), generator=gen),
           _normal(gen, (u, c), 0.05))
    x = _normal(gen, (2, 5, 5, c)).to(dtype)
    got = fused_middle_flow(x, *mid)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, fused_middle_flow_reference(x, *mid))
    assert library.fused_middle_flow(x, *mid).dtype == dtype

    cin, f0, f1 = 8, 16, 24
    blk = (_normal(gen, (9, cin), 0.3),
           _normal(gen, (cin, f0), 0.35).to(torch.bfloat16),
           torch.ones(f0), torch.zeros(f0), _normal(gen, (9, f0), 0.3),
           _normal(gen, (f0, f1), 0.25).to(torch.bfloat16),
           torch.ones(f1), torch.zeros(f1),
           _normal(gen, (cin, f1), 0.35).to(torch.bfloat16),
           torch.ones(f1), torch.zeros(f1))
    x = _normal(gen, (2, 7, 6, cin)).to(dtype)
    got = fused_strided_block(x, blk, True)
    assert got.dtype == dtype and got.shape == (2, 4, 3, f1)
    assert torch.equal(got, fused_strided_block_reference(x, blk, True))
    assert library.fused_strided_block(x, list(blk), 1).dtype == dtype
