"""The hand-written kernels against their plain versions, on the card."""

import numpy as np
import pytest
import torch

from cunvsm_torch.models.objectives import SparseGrad
from cunvsm_torch.ops import adam_sweep, cast, segment_kernels
from cunvsm_torch.optim import updates

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


# Segment-sum cases: (rows, width, stream, descriptors as (instances,
# window, weighted, Zipf exponent of the rows, some rows owned elsewhere)).
SEGMENT_CASES = {
    # nvsm.train's word table: 51,200 windows of 10 Zipf 1.07 words.
    "nvsm_words": (65536, 300, torch.bfloat16, [(51200, 10, False, 1.07, False)]),
    # nvsm.train's entity table: the labels and the pool of 2,048.
    "nvsm_entities": (262144, 256, torch.bfloat16,
                      [(51200, 1, False, 0.0, False), (2048, 1, False, 0.0, False)]),
    # mixnmatch.train's: labels, pool and the 102,400 rows of the pair stream.
    "mix_entities": (65536, 256, None, [(51200, 1, False, 0.0, False),
                                        (2048, 1, False, 0.0, False),
                                        (102400, 1, False, 0.667, False)]),
    # the expanded layout's weighted descriptor, and a width no multiple of 4
    "weighted_narrow": (1000, 3, torch.bfloat16,
                        [(4000, 4, True, 1.07, False), (300, 2, True, 0.0, False)]),
    # two column tiles, float32 weights, rows owned elsewhere dropped
    "wide_owned": (5000, 600, None, [(20000, 2, True, 1.07, True)]),
}


def _segment_case(name, cuda, seed=0):
    rows, dim, stream, layout = SEGMENT_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    descs = []
    for inst, window, weighted, exponent, owned in layout:
        p = torch.arange(1, rows + 1, device=cuda, dtype=torch.float64).pow(-exponent)
        idx = torch.multinomial(p.float(), inst * window, replacement=True, generator=g)
        descs.append(SparseGrad(
            torch.randn((inst, dim), device=cuda, generator=g) * 1e-3,
            idx.reshape(inst, window),
            torch.rand((inst, window), device=cuda, generator=g) * 2 - 0.5 if weighted else None,
            torch.rand((inst, window), device=cuda, generator=g) < 0.8 if owned else None,
        ))
    return rows, tuple(descs), stream


def _float64_scatter(rows, descs, stream):
    """(sum, sum of |term|, terms a row) in float64 of the kernel's rounded
    terms."""
    dim = descs[0].grad.shape[1]
    exact = torch.zeros((rows, dim), dtype=torch.float64, device=descs[0].grad.device)
    mass, count = torch.zeros_like(exact), torch.zeros_like(exact[:, 0])
    for d in descs:
        grad = d.grad if stream is None else d.grad.to(stream)
        t = grad[:, None, :].expand(*d.indices.shape, -1)
        if d.weights is not None:
            t = t * d.weights.to(grad.dtype)[:, :, None]
        t = t.reshape(-1, dim).double()
        idx = d.indices.reshape(-1)
        keep = torch.ones_like(idx, dtype=torch.bool) if d.owned is None else d.owned.reshape(-1)
        exact.index_add_(0, idx[keep], t[keep])
        mass.index_add_(0, idx[keep], t[keep].abs())
        count.index_add_(0, idx[keep], torch.ones_like(idx[keep], dtype=torch.float64))
    return exact, mass, count


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_sum_kernel_matches_plain_bitwise_on_card(cuda, case):
    """The kernel's sums are bitwise those of its plain version (the same
    plan, the same adds in the same order), within float32 rounding of a
    float64 scatter of the same terms (n * 2^-24 * sum |term|), zero where
    no entry falls, and bitwise the same in a second run."""
    rows, descs, stream = _segment_case(case, cuda)
    before = segment_kernels.segment_sum.launches
    got = segment_kernels.segment_sum(rows, descs, stream)
    torch.cuda.synchronize()
    assert segment_kernels.segment_sum.launches == before + 1
    assert torch.equal(got, segment_kernels.segment_sum_plain(rows, descs, stream))
    exact, mass, count = _float64_scatter(rows, descs, stream)
    assert torch.all((got.double() - exact).abs() <= count[:, None] * 2.0 ** -24 * mass)
    assert torch.all(got[count == 0] == 0) and bool((count == 0).any())
    assert int(count.max()) > 2 * segment_kernels.CHUNK or case == "nvsm_entities"
    assert torch.equal(segment_kernels.segment_sum(rows, descs, stream), got)


@pytest.mark.cuda
def test_segment_sum_runs_without_a_sync_and_replays_from_a_graph(cuda):
    """Plan and kernel never wait for the card, and one CUDA-graph capture
    of them replays to the eager bits, also after the gradient changes in
    place."""
    rows, descs, stream = _segment_case("nvsm_words", cuda)
    eager = segment_kernels.segment_sum(rows, descs, stream)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = segment_kernels.segment_sum(rows, descs, stream)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(again, eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        segment_kernels.segment_sum(rows, descs, stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = segment_kernels.segment_sum(rows, descs, stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    descs[0].grad.mul_(-3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, segment_kernels.segment_sum(rows, descs, stream))
    assert not torch.equal(captured, eager)


@pytest.mark.cuda
def test_card_accumulation_takes_the_kernel_unless_bfloat16_accumulates(cuda):
    rows, descs, stream = _segment_case("mix_entities", cuda)
    launches, calls = segment_kernels.segment_sum.launches, segment_kernels.index_add_sum.calls
    f32 = updates._sorted_segment_accumulate(rows, descs, stream)
    assert segment_kernels.segment_sum.launches == launches + 1
    assert segment_kernels.index_add_sum.calls == calls
    bf16 = updates._sorted_segment_accumulate(rows, descs, stream, torch.bfloat16)
    assert segment_kernels.index_add_sum.calls == calls + 1
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    torch.cuda.synchronize()
    assert torch.equal(f32, segment_kernels.segment_sum_plain(rows, descs, stream))
