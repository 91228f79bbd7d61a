"""``accum_dtype="bfloat16"`` under full_adam against the JAX package.

The weighted gradient rows, at stream width, are summed into a bfloat16
accumulator and the consumer widens (``cunvsm_tpu/optim/updates.py``
``_finish``).  Every add rounds the partial sum to bfloat16 (8 mantissa
bits, unit roundoff 2^-9), and the two packages add in another order, so
they agree only to the rounding model of ``TrainConfig.accum_dtype``: an
error of about 2^-9 * sqrt(n) per accumulator, n the updates into the
row, relative to the mass that was summed.  Here that mass is the row's L1
mass per column, L1[v, c] = sum |weights * grad[:, c]| over the updates
into v, so

    TOL[v, c] = 2^-9 * sqrt(n[v]) * L1[v, c]

is what random roundings add up to (the worst case is n * 2^-8 * L1): the
port is held to TOL against the exact sum, and the two packages to 2 * TOL
against each other, on inputs made from a fixed seed.  The moments and the tables after T steps inherit it
through the update rule (see ``test_three_full_adam_steps``).  With
``accum_dtype="float32"`` nothing changes: the rtol 1e-10 tests of
tests/test_torch_optim.py and tests/test_torch_train_step.py cover that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.optim import updates as jupd
from cunvsm_torch.cli import train as ttrain
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import params_from_numpy
from cunvsm_torch.optim import updates as tupd
from tests.torch_parity import (
    DESCS, both_batches, nonzero_state, numpy_batch, numpy_params, optimizer_config,
    run_both_steps, to_np, train_config, twin,
)

torch.set_num_threads(1)
ROWS, D, N_INST, WINDOW = 16, 8, 64, 4
U = 2.0 ** -9  # unit roundoff of bfloat16


def descriptor(seed, weighted=True, rows=ROWS, d=D, scale=1.0):
    rng = np.random.RandomState(seed)
    grad = (scale * rng.randn(N_INST, d)).astype(np.float32)
    idx = rng.randint(0, rows, (N_INST, WINDOW)).astype(np.int32)
    w = (rng.rand(N_INST, WINDOW) + 0.5).astype(np.float32) if weighted else None
    return grad, idx, w


def both_descs(grad, idx, w):
    return (
        jobj.SparseGrad(jnp.asarray(grad), jnp.asarray(idx), None if w is None else jnp.asarray(w)),
        tobj.SparseGrad(torch.from_numpy(grad), torch.from_numpy(idx).long(),
                        None if w is None else torch.from_numpy(w)),
    )


def exact_sum_and_tolerance(grad, idx, w, rows, stream=True):
    """(the float64 sum of the products as they enter the accumulator,
    TOL of the module doc)."""
    g = torch.from_numpy(grad)
    g = g.bfloat16() if stream else g
    terms = g[:, None, :].expand(-1, idx.shape[1], -1)
    if w is not None:
        wt = torch.from_numpy(w)
        terms = terms * (wt.bfloat16() if stream else wt)[:, :, None]
    terms = terms.bfloat16().double().numpy().reshape(-1, grad.shape[1])
    flat = idx.reshape(-1)
    exact, l1 = np.zeros((rows, grad.shape[1])), np.zeros((rows, grad.shape[1]))
    np.add.at(exact, flat, terms)
    np.add.at(l1, flat, np.abs(terms))
    n = np.bincount(flat, minlength=rows)
    return exact, U * np.sqrt(n)[:, None] * l1


@pytest.mark.parametrize("stream", ["bfloat16", None])
@pytest.mark.parametrize("weighted", [True, False])
def test_bfloat16_accumulator_matches_jax(weighted, stream):
    grad, idx, w = descriptor(0, weighted)
    jd, td = both_descs(grad, idx, w)
    j = jupd._sorted_segment_accumulate(
        ROWS, (jd,), stream and jnp.bfloat16, jnp.bfloat16)
    t = tupd._sorted_segment_accumulate(
        ROWS, (td,), stream and torch.bfloat16, torch.bfloat16)
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    exact, tol = exact_sum_and_tolerance(grad, idx, w, ROWS, stream=bool(stream))
    t, j = t.double().numpy(), np.asarray(j.astype(jnp.float64))
    assert np.all(np.abs(t - exact) <= tol)
    assert np.all(np.abs(t - j) <= 2 * tol)
    # Not the float32 accumulation rounded once at the end.
    f32 = tupd._sorted_segment_accumulate(ROWS, (td,), stream and torch.bfloat16)
    assert f32.dtype == torch.float32
    assert not torch.equal(f32.bfloat16().double(), torch.from_numpy(t))
    if stream:  # the same bfloat16 products, summed in float32
        np.testing.assert_allclose(f32.double().numpy(), exact, rtol=0, atol=1e-5)


def test_three_full_adam_steps():
    """Three ``Optimizer.apply`` calls of both packages on the same float32
    descriptors from the same non-zero state (m, v in U(0.01, 0.5), t = 5),
    bfloat16 stream and accumulator.  With dS = max 2 * TOL over the
    steps: m is linear in the accumulator, so |dm| <= T (1 - beta1) dS; the
    table moves by lr * bc * m / (sqrt(v) + eps) with sqrt(v) >= 0.1 and
    bc <= 1 / (1 - beta1^5), so |dp| <= T * lr * bc * |dm| / 0.1, doubled
    for the second-order terms (v's own change, the L2 term)."""
    steps, lr, lam, scale = 3, 0.01, 0.1, 0.02
    cfg = optimizer_config("full_adam", stream_dtype="bfloat16", accum_dtype="bfloat16",
                           learning_rate=lr, regularization_lambda=lam)
    rng = np.random.RandomState(3)
    shapes = dict(word=(ROWS, D), entity=(24, 6))
    np_params = JModelParams(rng.randn(*shapes["word"]).astype(np.float32),
                             rng.randn(*shapes["entity"]).astype(np.float32),
                             rng.randn(D, 6).astype(np.float32), rng.randn(6).astype(np.float32))
    jp = JModelParams(*(jnp.asarray(x) for x in np_params))
    jstate = nonzero_state(jupd.Optimizer(twin(cfg)).init(jp), 14)
    jstate = type(jstate)(*(type(s)(*(x.astype(jnp.float32) if x.dtype == jnp.float64 else x
                                      for x in s)) for s in jstate))
    tp, tstate = params_from_numpy(np_params), tupd.opt_state_from_numpy(jstate)
    ds = dict(word=0.0, entity=0.0)
    for step in range(steps):
        word = descriptor(20 + step, scale=scale)
        entity = descriptor(30 + step, False, *shapes["entity"], scale=scale)
        for name, d in (("word", word), ("entity", entity)):
            ds[name] = max(ds[name], 2 * exact_sum_and_tolerance(*d, shapes[name][0])[1].max())
        (jw, tw), (je, te) = both_descs(*word), both_descs(*entity)
        tw_, tb_ = rng.randn(D, 6).astype(np.float32), rng.randn(6).astype(np.float32)
        jp, jstate = jupd.Optimizer(twin(cfg)).apply(
            jp, jstate, jobj.AscentGrads((jw,), (je,), jnp.asarray(tw_), jnp.asarray(tb_)), lr, lam)
        tupd.Optimizer(cfg).apply(
            tp, tstate, tobj.AscentGrads((tw,), (te,), torch.from_numpy(tw_),
                                         torch.from_numpy(tb_)), lr, lam)
    bc = 1.0 / (1.0 - 0.9 ** 5)
    for name, jt, tt, js, ts in (("word", jp.word_reprs, tp.word_reprs, jstate.word, tstate.word),
                                 ("entity", jp.entity_reprs, tp.entity_reprs, jstate.entity,
                                  tstate.entity)):
        dm = steps * (1 - 0.9) * ds[name]
        dp = 2 * steps * lr * bc * dm / 0.1
        # The tolerances say something: m is of the order of 0.25, and the
        # table moves by more than dp over the three steps.
        moved = np.abs(to_np(tt) - getattr(np_params, f"{name}_reprs")).max()
        assert 0 < dm < 0.005 and dp < moved
        np.testing.assert_allclose(to_np(ts.m), np.asarray(js.m), rtol=0, atol=dm)
        np.testing.assert_allclose(to_np(tt), np.asarray(jt), rtol=0, atol=dp)
        assert not np.array_equal(to_np(ts.m), np.asarray(js.m))  # another order of adds
        assert int(ts.t) == int(js.t) == 8
    # The transform never goes through the accumulator.
    np.testing.assert_allclose(to_np(tp.transform_w), np.asarray(jp.transform_w), rtol=1e-5)


@pytest.mark.parametrize("desc_name,pool", [("nvsm", 8), ("lse", 0)])
def test_three_train_steps_with_bfloat16_accumulation(desc_name, pool):
    """Both packages' ``make_train_step`` in float32 from a zero state.  The
    first cost comes before any accumulation (rtol 1e-6); later costs see
    tables that differ by rounded gradients (rtol 2^-9, one bfloat16
    rounding); a table entry moves by at most about lr per Adam step
    whatever the gradient's error, so 3 * lr bounds the tables."""
    cfg = train_config(stream_dtype="bfloat16", accum_dtype="bfloat16",
                       negative_pool_size=pool, uniform_feature_weights=desc_name == "nvsm")
    batches = [both_batches(numpy_batch(40 + i, dtype=np.float32, weighted=desc_name == "lse"))
               for i in range(3)]
    result = run_both_steps(DESCS[desc_name], cfg, batches, numpy_params(41, dtype=np.float32))
    jparams, _, tparams, tstate, jcosts, tcosts = result
    np.testing.assert_allclose(tcosts[0], jcosts[0], rtol=1e-6)
    np.testing.assert_allclose(tcosts, jcosts, rtol=U)
    for j, t in zip(jparams, tparams):
        np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=0, atol=3 * cfg.learning_rate)
    assert tstate.word.m.dtype == torch.float32


def test_accum_dtype_reaches_the_optimizer_from_the_command_line():
    args = ttrain.build_parser().parse_args(
        ["corpus", "--accum_dtype", "bfloat16", "--update_method", "full_adam",
         "--nonlinearity", "tanh", "--output", "m"])
    assert args.accum_dtype == "bfloat16"
    opt = tupd.Optimizer(optimizer_config("full_adam", accum_dtype="bfloat16"))
    assert opt.accum_dtype == torch.bfloat16
    assert tupd.Optimizer(optimizer_config("full_adam")).accum_dtype is None
    # Only full_adam reads the field, as in the JAX package.
    tupd.Optimizer(optimizer_config("sgd", accum_dtype="bfloat16"))
