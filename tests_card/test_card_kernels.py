"""Both hand-written kernels against their plain versions, on the card."""

import numpy as np
import pytest
import torch

from cunvsm_torch.ops import adam_sweep, cast

HYPER = dict(lam=0.01 / 51200, beta1=0.9, beta2=0.999, eps=1e-6)


def _f32(bits):
    return np.array(bits, dtype=np.uint32).view(np.float32)


CAST_EDGES = np.concatenate([
    _f32([0x7F800000, 0xFF800000, 0x3F800000, 0xC0490FDB]),  # inf
    _f32([0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x007FFFFF,
          0x00400000, 0x807FFFFF, 0x0000FFFF]),  # subnormal
    _f32([0x80000000, 0x00000000, 0x80000000, 0x3F800000]),  # negative zero
    # 3.4e38 and the float32 maximum round to inf; 0x7F7F8000 is the exact
    # tie, which rounds to the even neighbour, inf.
    np.array([3.4e38, -3.4e38], np.float32),
    _f32([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF]),
    _f32([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80C000, 0x4B7F8000, 0x4B7E8000]),  # ties
    _f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF]),  # NaN
])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65536, 300), (262144, 256), (1000, 3)])
def test_sweep_kernel_matches_plain_on_card(cuda, shape):
    """Bitwise: the kernel computes the plain version's IEEE operations in
    its order (``_rn`` division and square root, no FMA contraction).  Half
    the gradient rows are zero, so there agg is the L2 term alone, and v is
    of the order of s**2: a kernel that drops lam or never stores v' fails."""
    g = torch.Generator(device=cuda).manual_seed(0)
    s = torch.randn(shape, device=cuda, generator=g) * 1e-3
    s[shape[0] // 2:] = 0.0
    m = torch.randn(shape, device=cuda, generator=g) * 1e-4
    v = torch.rand(shape, device=cuda, generator=g) * 2e-6
    p = (torch.rand(shape, device=cuda, generator=g) - 0.5) * 0.2
    scale = torch.tensor(3e-5, device=cuda)
    ref = [t.clone() for t in (p, m, v)]
    no_l2 = [t.clone() for t in (p, m, v)]
    adam_sweep.sweep_plain(*ref, s, scale, **HYPER)
    adam_sweep.sweep_plain(*no_l2, s, scale, **{**HYPER, "lam": 0.0})
    for before, after in zip((p, m, v), ref):
        assert not torch.equal(before, after)
    assert not torch.equal(ref[0], no_l2[0]) and not torch.equal(ref[1], no_l2[1])
    before = adam_sweep.fused_adam_dense_sweep.launches
    adam_sweep.fused_adam_dense_sweep(p, m, v, s, scale, **HYPER)
    torch.cuda.synchronize()
    assert adam_sweep.fused_adam_dense_sweep.launches == before + 1
    for r, t in zip(ref, (p, m, v)):
        assert torch.equal(t, r)


def _card_cast_operand(case, cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    if case == "edges":
        bits = torch.randint(-2**31, 2**31, (4097,), device=cuda, generator=g,
                             dtype=torch.int64).to(torch.int32)
        edges = torch.from_numpy(CAST_EDGES.view(np.int32))
        return torch.cat([edges.to(cuda), bits]).view(torch.float32)
    if case == "misaligned":
        return (torch.randn(1001, device=cuda, generator=g) * 1e3)[1:]
    if case == "misaligned_table":
        return torch.randn((65536, 300), device=cuda, generator=g).view(-1)[1:]
    return torch.randn(case, device=cuda, generator=g) * 1e3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(65536, 300), (5, 7), "edges", "misaligned",
                                  "misaligned_table", 1, 5, 7, 9])
def test_cast_kernel_bitwise_on_card(cuda, case):
    """Bitwise ``.to(torch.bfloat16)`` wherever the result is not NaN, and
    NaN where it is, at the main path's shape, on edge values and random bit
    patterns, on slices that start one element in (misaligned base, odd n),
    and for n < 8."""
    x = _card_cast_operand(case, cuda)
    before = cast.cast_table.launches
    y = cast.cast_table(x, torch.bfloat16)
    torch.cuda.synchronize()
    assert cast.cast_table.launches == before + 1
    ref = x.to(torch.bfloat16)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(y), nan)
    assert torch.equal(y.view(torch.int16)[~nan], ref.view(torch.int16)[~nan])
