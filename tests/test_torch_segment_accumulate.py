"""full_adam's sorted segment sum (``cunvsm_torch/ops/segment_kernels.py``)
on the CPU: the plan, the plain version of the kernel's fixed order, the
dispatch and its counters.

The kernel itself runs only on a card (``tests_card/test_card_kernels.py``
holds it bitwise to :func:`segment_sum_plain`).  Here the plain version is
held to a float64 scatter of the same rounded terms, within the float32
bound of a sum in any order, n * 2^-24 * sum |term| per row and column
(n terms in the row), and to a scalar loop written from the kernel's
description, bitwise, and to the JAX package's
``_sorted_segment_accumulate`` on the same descriptors, within twice that
bound.  The inputs are Zipf-like, so that one row is longer than several
chunks and rows start inside chunks.
"""

import ctypes
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.optim import updates as jupd
from cunvsm_torch.config import AdamConfig, AdamMode, TrainConfig, UpdateMethod
from cunvsm_torch.models.objectives import AscentGrads, SparseGrad
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.ops import cuda_build, segment_kernels as sk
from cunvsm_torch.optim import updates

C = sk.CHUNK
U32 = 2.0 ** -24


def _zipf_rows(rng, shape, num_rows, hot=0):
    """Row ids with a Zipf-like head; ``hot`` more entries of row 3."""
    ranks = np.minimum(rng.zipf(1.3, size=shape) - 1, num_rows - 1)
    rows = (ranks * 7919 + 3) % num_rows
    flat = rows.reshape(-1)
    flat[rng.permutation(flat.size)[:hot]] = 3
    return torch.from_numpy(rows.astype(np.int64))


def descriptor(seed, instances, window, num_rows, dim, weighted, hot=0, owned=False):
    rng = np.random.RandomState(seed)
    grad = torch.from_numpy((rng.randn(instances, dim) * 0.3).astype(np.float32))
    indices = _zipf_rows(rng, (instances, window), num_rows, hot)
    weights = None
    if weighted:
        weights = torch.from_numpy((rng.rand(instances, window) * 2 - 0.5).astype(np.float32))
    mask = torch.from_numpy(rng.rand(instances, window) < 0.7) if owned else None
    return SparseGrad(grad, indices, weights, mask)


# (instances, window, weighted, hot entries of row 3) per descriptor
LAYOUTS = {
    "one": [(600, 10, False, 0)],
    "one_weighted": [(600, 10, True, 0)],
    "one_hot": [(700, 10, False, 5 * C + 37)],
    "two": [(500, 10, True, 3 * C), (80, 1, False, 0)],
    "three": [(400, 1, False, 2 * C + 5), (64, 1, False, 0), (900, 1, True, 0)],
    "three_weighted": [(300, 4, True, C + 1), (64, 2, True, 0), (900, 1, True, C)],
}


def descriptors(layout, num_rows=97, dim=12, owned=False):
    return tuple(
        descriptor(10 + k, inst, win, num_rows, dim, weighted, hot, owned)
        for k, (inst, win, weighted, hot) in enumerate(LAYOUTS[layout])
    )


def rounded_terms(d, stream_dtype):
    """[B, W, dim] float32: each entry's term as ``index_add_sum`` rounds it."""
    grad = d.grad if stream_dtype is None else d.grad.to(stream_dtype)
    t = grad[:, None, :].expand(*d.indices.shape, -1)
    if d.weights is not None:
        t = t * d.weights.to(grad.dtype)[:, :, None]
    return t.to(torch.float32)


def oracle(num_rows, descs, stream_dtype):
    """(float64 sum, float64 sum of |term|, terms a row), every term rounded
    as the kernel rounds it."""
    dim = descs[0].grad.shape[1]
    exact = torch.zeros((num_rows, dim), dtype=torch.float64)
    mass = torch.zeros((num_rows, dim), dtype=torch.float64)
    count = torch.zeros(num_rows, dtype=torch.float64)
    for d in descs:
        t = rounded_terms(d, stream_dtype).reshape(-1, dim).to(torch.float64)
        rows = d.indices.reshape(-1)
        keep = torch.ones_like(rows, dtype=torch.bool) if d.owned is None else d.owned.reshape(-1)
        exact.index_add_(0, rows[keep], t[keep])
        mass.index_add_(0, rows[keep], t[keep].abs())
        count.index_add_(0, rows[keep], torch.ones(int(keep.sum()), dtype=torch.float64))
    return exact, mass, count


def assert_within_rounding(got, num_rows, descs, stream_dtype):
    exact, mass, count = oracle(num_rows, descs, stream_dtype)
    assert got.dtype == torch.float32
    err = (got.to(torch.float64) - exact).abs()
    assert torch.all(err <= count[:, None] * U32 * mass), float((err - count[:, None] * U32 * mass).max())
    assert torch.all(got[count == 0] == 0)


def scalar_loop(num_rows, descs, stream_dtype):
    """The kernel's order written out one float32 add at a time with numpy
    scalars, from the plan."""
    plan = sk.plan_segments(num_rows, descs)
    terms = sk._sorted_terms(descs, plan, stream_dtype).numpy()
    off = plan.offsets.numpy().astype(np.int64)
    out = np.zeros((num_rows, terms.shape[1]), np.float32)

    def run(s, e):
        acc = np.zeros(terms.shape[1], np.float32)
        for i in range(s, e):
            acc = (acc + terms[i]).astype(np.float32)
        return acc

    for v in range(num_rows):
        s, e = off[v], off[v + 1]
        if e == s or s // C == (e - 1) // C:
            out[v] = run(s, e)
            continue
        acc = np.zeros(terms.shape[1], np.float32)
        for q in range(s // C, (e - 1) // C + 1):
            acc = (acc + run(max(s, q * C), min(e, (q + 1) * C))).astype(np.float32)
        out[v] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("owned", [False, True])
@pytest.mark.parametrize("layout", ["one", "two", "three"])
def test_plan_sorts_stably_and_bounds_every_row(layout, owned):
    num_rows = 97
    descs = descriptors(layout, num_rows, owned=owned)
    plan = sk.plan_segments(num_rows, descs)
    keys = torch.cat([
        torch.where(d.owned.reshape(-1), d.indices.reshape(-1), num_rows)
        if d.owned is not None else d.indices.reshape(-1)
        for d in descs
    ])
    assert plan.rows.dtype == torch.int32 and plan.offsets.dtype == torch.int32
    assert plan.perm.dtype == torch.int64
    assert torch.equal(plan.rows.long(), keys[plan.perm])
    assert torch.equal(torch.sort(plan.perm).values, torch.arange(keys.numel()))
    # stable: within a row, the entries keep the order of the concatenation
    same = plan.rows[1:] == plan.rows[:-1]
    assert torch.all(plan.perm[1:][same] > plan.perm[:-1][same])
    off = plan.offsets.long()
    assert off.shape == (num_rows + 1,) and off[0] == 0
    assert int(off[-1]) == int((keys < num_rows).sum())
    for v in range(num_rows):
        assert torch.all(plan.rows[off[v]:off[v + 1]] == v)


@pytest.mark.parametrize("num_rows", [40000, 2**16, 2**16 + 1])
def test_plan_keeps_the_order_of_sixteen_bit_keys(num_rows):
    """Tables about 65,536 rows long, whose ids fill sixteen bits: rows on
    both sides of 32,768 and the last row keep their order and their int32
    ids."""
    rng = np.random.RandomState(5)
    idx = torch.from_numpy(rng.randint(0, num_rows, (3000, 3)))
    idx[0, 0], idx[1, 1], idx[2, 2] = num_rows - 1, 0, 2**15
    d = SparseGrad(torch.zeros(3000, 2), idx, None)
    plan = sk.plan_segments(num_rows, (d,))
    rows, perm = torch.sort(idx.reshape(-1), stable=True)
    assert plan.rows.dtype == torch.int32
    assert torch.equal(plan.rows.long(), rows) and torch.equal(plan.perm, perm)
    assert torch.equal(plan.offsets.long(), torch.searchsorted(rows, torch.arange(num_rows + 1)))


@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_fixed_order_matches_float64_scatter(layout, stream_dtype):
    num_rows = 97
    descs = descriptors(layout, num_rows)
    got = sk.segment_sum_plain(num_rows, descs, stream_dtype)
    assert_within_rounding(got, num_rows, descs, stream_dtype)


@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["one_hot", "three_weighted"])
def test_plain_version_is_the_kernels_order_bitwise(layout, stream_dtype):
    """A row within one chunk of the sorted array term by term from 0, a
    row across the multiples of CHUNK by pieces, the pieces in order from
    0."""
    num_rows = 97
    descs = descriptors(layout, num_rows)
    counts = sk.plan_segments(num_rows, descs).offsets.diff()
    assert int(counts.max()) > 5 * C if layout == "one_hot" else int(counts.max()) > C
    got = sk.segment_sum_plain(num_rows, descs, stream_dtype)
    assert torch.equal(got, scalar_loop(num_rows, descs, stream_dtype))


@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_fixed_order_matches_the_jax_package(layout, stream_dtype):
    """The JAX package's sort, gather and segment sum on the same
    descriptors: one, two and three of them, weighted or not, a hot row,
    float32 and bfloat16 streams.  Each sum lies within n * 2^-24 * mass of
    the exact one, so the two lie within twice that of each other."""
    num_rows = 97
    descs = descriptors(layout, num_rows)
    got = sk.segment_sum_plain(num_rows, descs, stream_dtype)
    jdescs = tuple(
        jobj.SparseGrad(jnp.asarray(d.grad.numpy()), jnp.asarray(d.indices.numpy().astype(np.int32)),
                        None if d.weights is None else jnp.asarray(d.weights.numpy()))
        for d in descs
    )
    ref = jupd._sorted_segment_accumulate(
        num_rows, jdescs, None if stream_dtype is None else jnp.bfloat16)
    assert ref.dtype == jnp.float32 and ref.shape == tuple(got.shape)
    ref = torch.from_numpy(np.asarray(ref, dtype=np.float64))
    _, mass, count = oracle(num_rows, descs, stream_dtype)
    err = (got.to(torch.float64) - ref).abs()
    assert torch.all(err <= 2 * count[:, None] * U32 * mass), float(err.max())
    assert torch.all(ref[count == 0] == 0)


def test_rounding_follows_the_stream():
    """bfloat16 streams round the gradient, the weight and their product;
    the float32 sum of such terms differs from the float32 stream's."""
    descs = descriptors("one_weighted")
    f32 = sk.segment_sum_plain(97, descs)
    bf16 = sk.segment_sum_plain(97, descs, torch.bfloat16)
    assert not torch.equal(f32, bf16)
    assert_within_rounding(bf16, 97, descs, torch.bfloat16)
    d = descs[0]
    g, w = d.grad.to(torch.bfloat16), d.weights.to(torch.bfloat16)
    plan = sk.plan_segments(97, descs)
    term = sk._sorted_terms(descs, plan, torch.bfloat16)[0]
    e = int(plan.perm[0])
    assert torch.equal(term, (g[e // 10] * w.reshape(-1)[e]).float())


@pytest.mark.parametrize("rows", [1, 5, 97])
def test_empty_rows_are_zero_and_no_entries_give_zeros(rows):
    """Every row is written: untouched rows as zeros, and a table whose
    entries all belong to another owner comes out all zeros."""
    d = descriptor(3, 50, 2, 4, 12, True)
    d = d._replace(indices=d.indices % min(rows, 4))
    got = sk.segment_sum_plain(rows + 30, (d,))
    assert torch.all(got[min(rows, 4):] == 0)
    assert_within_rounding(got, rows + 30, (d,), None)
    nobody = d._replace(owned=torch.zeros(d.indices.shape, dtype=torch.bool))
    assert torch.equal(sk.segment_sum_plain(rows, (nobody,)), torch.zeros(rows, 12))


@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_owned_elsewhere_are_left_out(stream_dtype):
    descs = descriptors("three", owned=True)
    got = sk.segment_sum_plain(97, descs, stream_dtype)
    assert_within_rounding(got, 97, descs, stream_dtype)
    assert torch.equal(got, scalar_loop(97, descs, stream_dtype))


def _rank(model_index):
    return SimpleNamespace(model=3, model_index=model_index, data=2, size=6,
                           shape={"data": 2, "model": 3})


@pytest.mark.parametrize("model_index", [0, 1, 2])
def test_a_mesh_ranks_partial(model_index):
    """A rank's slice of its data group's descriptors (``_every_rank_slice``),
    as ``_data_sharded_accumulate`` sums it before the all-reduce; the
    three ranks' partials add up to the group's sum."""
    # 690 and 78 instances: both divide by the model axis of 3.
    descs = (descriptor(20, 690, 10, 97, 12, False, hot=4 * C),
             descriptor(21, 78, 1, 97, 12, True))
    local = tuple(updates._every_rank_slice(d, _rank(model_index)) for d in descs)
    assert [d.indices.shape[0] for d in local] == [230, 26]
    assert_within_rounding(sk.segment_sum_plain(97, local, torch.bfloat16), 97, local,
                           torch.bfloat16)
    total = sum(
        sk.segment_sum_plain(
            97, tuple(updates._every_rank_slice(d, _rank(m)) for d in descs), torch.bfloat16
        ).double()
        for m in range(3)
    )
    exact, mass, count = oracle(97, descs, torch.bfloat16)
    # each rank's partial within its rounding, and two more adds of them
    assert torch.all((total - exact).abs() <= (count[:, None] + 2) * U32 * mass)


class _OnCard:
    """A CPU tensor that answers as a CUDA one for ``kernel_takes``."""

    def __init__(self, t):
        self.t, self.is_cuda, self.dtype, self.shape = t, True, t.dtype, t.shape


def _card(d, **changes):
    d = d._replace(**changes)
    return d._replace(grad=_OnCard(d.grad), weights=None if d.weights is None else _OnCard(d.weights))


def test_kernel_takes_card_descriptors_into_float32():
    one, two, three = (descriptors(k) for k in ("one_weighted", "two", "three"))
    assert sk.kernel_takes(tuple(_card(d) for d in one))
    assert sk.kernel_takes(tuple(_card(d) for d in two), torch.bfloat16)
    assert sk.kernel_takes(tuple(_card(d) for d in three), torch.float32, torch.float32)
    card = tuple(_card(d) for d in three)
    refused = {
        "the CPU": (one, None, None),
        "a bfloat16 accumulator": (card, torch.bfloat16, torch.bfloat16),
        "a float16 stream": (card, torch.float16, None),
        "four descriptors": (card + card[:1], None, None),
        "no descriptor": ((), None, None),
        "float64 gradients": ((_card(one[0], grad=one[0].grad.double()),), None, None),
        "float64 weights": ((_card(one[0], weights=one[0].weights.double()),), None, None),
        "two widths": ((card[0], _card(three[1], grad=three[1].grad[:, :5])), None, None),
    }
    for why, (descs, stream, accum) in refused.items():
        assert not sk.kernel_takes(descs, stream, accum), why


def test_segment_sum_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no kernel"):
        sk.segment_sum(97, descriptors("one"))


@pytest.mark.parametrize("accum_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_the_cpu_and_a_bfloat16_accumulator_keep_index_add(accum_dtype):
    descs = descriptors("two")
    calls, launches = sk.index_add_sum.calls, sk.segment_sum.launches
    got = updates._sorted_segment_accumulate(97, descs, torch.bfloat16, accum_dtype)
    assert sk.index_add_sum.calls == calls + 1 and sk.segment_sum.launches == launches
    assert got.dtype == (accum_dtype or torch.float32)
    if accum_dtype is None:
        assert_within_rounding(got, 97, descs, torch.bfloat16)


def test_card_accumulation_goes_through_the_plan_and_the_kernel(monkeypatch):
    """On a card ``_sorted_segment_accumulate`` takes the kernel: the
    launcher receives the plan, ``segment_sum.launches`` counts it and
    ``index_add_sum`` is not called.  The launcher is the plain version
    here."""
    seen = []

    def launch(num_rows, descs, stream_dtype, plan):
        seen.append(plan)
        return sk.segment_sum_plain(num_rows, descs, stream_dtype, plan)

    monkeypatch.setattr(sk, "kernel_takes", lambda descs, stream=None, accum=None: True)
    monkeypatch.setattr(sk, "_launch", launch)
    descs = descriptors("three_weighted")
    calls, launches = sk.index_add_sum.calls, sk.segment_sum.launches
    got = updates._sorted_segment_accumulate(97, descs, torch.bfloat16)
    assert sk.segment_sum.launches == launches + 1 and sk.index_add_sum.calls == calls
    assert len(seen) == 1 and seen[0].offsets.shape == (98,)
    assert torch.equal(got, scalar_loop(97, descs, torch.bfloat16))


def test_full_adam_counts_one_accumulation_a_table():
    cfg = TrainConfig(update_method=UpdateMethod.ADAM,
                      adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE))
    rng = np.random.RandomState(0)
    params = ModelParams(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                           for s in ((97, 12), (40, 8), (8, 12), (8,))))
    opt = updates.Optimizer(cfg)
    state = opt.init(params)
    word = descriptors("one")
    entity = (descriptor(5, 30, 1, 40, 8, False), descriptor(6, 12, 1, 40, 8, False))
    grads = AscentGrads(word, entity, torch.zeros(8, 12), torch.zeros(8))
    calls = sk.index_add_sum.calls
    opt.apply(params, state, grads, 1e-3, 1e-4)
    assert sk.index_add_sum.calls == calls + 2


def test_bind_declares_the_c_signature():
    """Pointers, pointer arrays and the stream as c_void_p, sizes as long
    long, the descriptor count and the stream flag as int."""
    lib = SimpleNamespace(cunvsm_segment_sum_f32=SimpleNamespace())
    fn = sk.bind(lib)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert fn.argtypes == [p, p, p, ll, ll, ll, i, p, p, p, p, i, ll, p, p, p]
    assert fn.restype is ctypes.c_int


def test_source_declares_the_bound_entry_point():
    src = open(os.path.join(cuda_build.CSRC, "segment_sum.cu")).read()
    at = src.index('extern "C"')
    decl = " ".join(src[at:src.index("{", at)].split())
    assert decl == (
        'extern "C" int cunvsm_segment_sum_f32(const int* rows, const long long* perm, '
        "const int* offsets, long long n, long long num_rows, long long dim, int num_desc, "
        "const float* const* grads, const float* const* weights, const long long* starts, "
        "const long long* windows, int bf16_stream, long long chunk, float* out, "
        "float* partials, cudaStream_t stream)"
    )
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code


def test_launcher_raises_without_nvcc(monkeypatch, tmp_path):
    """What a card's accumulation meets on a machine without nvcc: an error
    naming nvcc, not the index_add_ path."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build" / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        sk._segment_kernel.__wrapped__()
