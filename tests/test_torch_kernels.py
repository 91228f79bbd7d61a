"""The port's two kernel modules against the JAX package's Pallas kernels.

Here, on the CPU, each wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode.  The kernels themselves (the Triton sweep,
the CUDA C++ cast) run only on the card: the ``cuda`` tests below compare
them with the plain versions there and skip elsewhere.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.ops.adam_sweep import _sweep_pallas
from cunvsm_tpu.ops.cast import _cast_pallas
from cunvsm_torch.ops import adam_sweep, cast, window_mean

torch.set_num_threads(1)

HYPER = dict(lam=0.01 / 51200, beta1=0.9, beta2=0.999, eps=1e-6)


def _sweep_inputs(rng, shape, dtype):
    s = rng.randn(*shape) * 1e-3
    m = rng.randn(*shape) * 1e-4
    v = np.abs(rng.randn(*shape)) * 1e-7
    p = rng.uniform(-0.1, 0.1, shape)
    return [x.astype(dtype) for x in (s, m, v, p)]


@pytest.mark.parametrize("shape", [(37, 12), (600, 300), (1030, 256)])
def test_sweep_plain_matches_pallas_interpret_f64(shape):
    s, m, v, p = _sweep_inputs(np.random.RandomState(0), shape, np.float64)
    scale = 1e-3 * 0.0316
    jm, jv, jp = _sweep_pallas(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jnp.asarray(s), scale,
        interpret=True, **HYPER,
    )
    tm, tv, tp, ts = (torch.from_numpy(x.copy()) for x in (m, v, p, s))
    before = adam_sweep.fused_adam_dense_sweep.launches
    adam_sweep.fused_adam_dense_sweep(
        tp, tm, tv, ts, torch.tensor(scale, dtype=torch.float64), **HYPER
    )
    assert adam_sweep.fused_adam_dense_sweep.launches == before  # plain path
    np.testing.assert_array_equal(ts.numpy(), s)  # read only
    for j, t in ((jm, tm), (jv, tv), (jp, tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-14)


def test_sweep_plain_f32_near_pallas_interpret():
    s, m, v, p = _sweep_inputs(np.random.RandomState(1), (257, 300), np.float32)
    jm, jv, jp = _sweep_pallas(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jnp.asarray(s),
        jnp.float32(3e-5), interpret=True, **HYPER,
    )
    tm, tv, tp, ts = (torch.from_numpy(x.copy()) for x in (m, v, p, s))
    adam_sweep.fused_adam_dense_sweep(tp, tm, tv, ts, torch.tensor(3e-5), **HYPER)
    # atol scales with each tensor (v' is about 1e-7): a fixed 1e-7 would not
    # see a wrong v'.
    for j, t in ((jm, tm), (jv, tv), (jp, tp)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("shape", [(2050, 300), (7, 256), (1, 3)])
def test_cast_plain_bitwise_equals_pallas_interpret(shape):
    rng = np.random.RandomState(2)
    x = (rng.randn(*shape) * np.exp(rng.uniform(-20, 20, shape))).astype(np.float32)
    # Exact ties of the round-to-nearest-even rule.
    x.reshape(-1)[: min(4, x.size)] = np.array(
        [1.00390625, 1.01171875, -1.00390625, 3.0e38], np.float32
    )[: min(4, x.size)]
    j = np.asarray(_cast_pallas(jnp.asarray(x), jnp.bfloat16, interpret=True))
    before = cast.cast_table.launches
    t = cast.cast_table(torch.from_numpy(x), torch.bfloat16)
    assert cast.cast_table.launches == before
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


# float32 values at the edges of the float32 -> bfloat16 rounding.
CAST_EDGES = {
    "inf": _f32([0x7F800000, 0xFF800000, 0x3F800000, 0xC0490FDB]),
    "subnormal": _f32([0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x007FFFFF,
                       0x00400000, 0x807FFFFF, 0x0000FFFF]),
    "neg_zero": _f32([0x80000000, 0x00000000, 0x80000000, 0x3F800000]),
    # 3.4e38 and the float32 maximum lie above the largest finite bfloat16
    # (0x7F7F) by more than half an ulp and round to inf; 0x7F7F8000 is the
    # exact tie, which rounds to the even neighbour, inf.
    "overflow_to_inf": np.concatenate([
        np.array([3.4e38, -3.4e38], np.float32),
        _f32([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF]),
    ]),
    "ties": _f32([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80C000, 0x4B7F8000, 0x4B7E8000]),
    "nan": _f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC00001, 0x7FFFFFFF, 0x3F800000]),
}


@pytest.mark.parametrize("case", sorted(CAST_EDGES))
def test_cast_plain_edge_values_bitwise_equal_pallas_interpret(case):
    """Edge values through the port's CPU cast and the Pallas kernel in
    interpret mode: bitwise equal, NaN compared as NaN (its payload is not
    part of the contract)."""
    x = CAST_EDGES[case].reshape(2, -1)
    j = np.asarray(_cast_pallas(jnp.asarray(x), jnp.bfloat16, interpret=True))
    before = cast.cast_table.launches
    t = cast.cast_table(torch.from_numpy(x), torch.bfloat16)
    assert cast.cast_table.launches == before
    nan = np.isnan(x)
    np.testing.assert_array_equal(torch.isnan(t).numpy(), nan)
    np.testing.assert_array_equal(np.isnan(j.astype(np.float32)), nan)
    np.testing.assert_array_equal(t.view(torch.int16).numpy()[~nan], j.view(np.int16)[~nan])
    if case == "overflow_to_inf":
        assert np.isinf(t.float().numpy()).sum() == 5


def test_cast_of_same_dtype_is_identity():
    x = torch.ones(3, 4)
    assert cast.cast_table(x, torch.float32) is x


@pytest.mark.parametrize("wrapper", ["sweep", "cast", "window_mean"])
def test_non_cpu_tensor_never_takes_the_plain_version(wrapper):
    """A tensor that is not on the CPU goes to the kernel launcher, which
    raises here (no card, no triton); it is never routed to the plain
    version and the launch count does not move."""
    x = torch.empty((4, 8), device="meta")
    if wrapper == "sweep":
        fn, call = adam_sweep.fused_adam_dense_sweep, lambda: adam_sweep.fused_adam_dense_sweep(
            x, x, x, x, torch.empty((), device="meta"), **HYPER)
    elif wrapper == "cast":
        fn, call = cast.cast_table, lambda: cast.cast_table(x, torch.bfloat16)
    else:
        ids = torch.zeros((2, 3), dtype=torch.int64, device="meta")
        fn, call = window_mean.window_mean, lambda: window_mean.window_mean(x, ids, None)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for meta"):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("module,names,branch", [
    (adam_sweep, ("fused_adam_dense_sweep", "_launch_sweep", "_sweep_kernel"),
     "if table.is_cuda:"),
    (cast, ("cast_table", "_launch_cast", "_cast_kernel", "bind"), "if x.is_cuda:"),
    (window_mean, ("window_mean", "_launch", "_window_mean_kernel", "bind"),
     "if word_reprs.is_cuda:"),
])
def test_dispatch_has_no_fallback(module, names, branch):
    """The dispatch branches on the tensor's device only: no try/except
    that could fall back to the plain version, no environment switch."""
    for name in names:
        src = inspect.getsource(getattr(module, name))
        for word in ("try:", "except", "environ", "getenv"):
            assert word not in src, (name, word)
    assert branch in inspect.getsource(getattr(module, names[0]))




@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_window_mean_of_a_cpu_table_is_the_plain_version(dtype, weighted):
    """A CPU table takes the plain version, bitwise, and launches nothing."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn((40, 12), generator=g).to(dtype)
    ids = torch.randint(0, 40, (9, 5), generator=g)
    fw = torch.rand((9, 5), generator=g) if weighted else None
    before = window_mean.window_mean.launches
    for sums in (None, dtype):
        got = window_mean.window_mean(table, ids, fw, sums)
        assert torch.equal(got, window_mean.window_mean_plain(table, ids, fw, sums))
        assert got.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    assert window_mean.window_mean.launches == before
