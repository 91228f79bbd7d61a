"""The port's optimizers against the JAX package and the closed forms.

* Every optimizer (sgd, adagrad, sparse_adam, dense_adam, full_adam) at
  (lambda, lr) in {(0, 1.0), (0.1, 0.5)} (tests/test_optim.py:92), three
  steps from a non-zero state with duplicate indices, through both
  packages' ``Optimizer.apply`` on the same float64 descriptors: tables and
  every state leaf agree to rtol 1e-10 (atol 1e-14; the two sum duplicates
  in another order).  From the second step on, a sparse mode that decayed
  only the touched rows of m and v would differ.
* The closed forms of tests/test_optim.py:96-314, held to the port at the
  same tolerances as there.
* The single-descriptor guards of Adagrad and sparse Adam: both packages
  refuse the same input (JAX asserts, the port raises ValueError).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.optim import updates as jupd
from cunvsm_torch.config import UPDATE_METHOD_NAMES
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import params_from_numpy
from cunvsm_torch.ops import segment_kernels as sk
from cunvsm_torch.optim import updates as tupd
from tests.torch_parity import nonzero_state, optimizer_config, to_np, twin

torch.set_num_threads(1)

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 6, 4, 3, 2
RTOL, ATOL = 1e-10, 1e-14
LAM_LR_GRID = [(0.0, 1.0), (0.1, 0.5)]
BETA1, BETA2, EPS = 0.9, 0.999, 1e-6

OPTIMIZERS = sorted(UPDATE_METHOD_NAMES)


def cfg_for(name, lr=0.5, lam=0.1):
    return optimizer_config(name, learning_rate=lr, regularization_lambda=lam)


def np_params(seed=0):
    rng = np.random.RandomState(seed)
    return JModelParams(
        rng.randn(NUM_WORDS, D_W), rng.randn(NUM_ENTITIES, D_E),
        rng.randn(D_W, D_E), rng.randn(D_E),
    )


def np_grads(seed=0, window=2, num_instances=3):
    """Word descriptor with weights and duplicate indices within and
    across windows; entity descriptor weight-free, window 1."""
    rng = np.random.RandomState(seed + 50)
    return dict(
        word=(rng.randn(num_instances, D_W),
              rng.randint(0, NUM_WORDS, (num_instances, window)).astype(np.int32),
              rng.rand(num_instances, window) + 0.5),
        entity=(rng.randn(num_instances, D_E),
                rng.randint(0, NUM_ENTITIES, (num_instances, 1)).astype(np.int32), None),
        transform_w=rng.randn(D_W, D_E),
        transform_b=rng.randn(D_E),
    )


def jax_grads(g, tables=("word", "entity"), transform=True):
    def desc(x):
        grad, idx, w = x
        return jobj.SparseGrad(jnp.asarray(grad), jnp.asarray(idx),
                               None if w is None else jnp.asarray(w))

    return jobj.AscentGrads(
        word=tuple(desc(x) for x in g["word_list"]) if "word_list" in g else
        ((desc(g["word"]),) if "word" in tables else ()),
        entity=(desc(g["entity"]),) if "entity" in tables else (),
        transform_w=jnp.asarray(g["transform_w"]) if transform else None,
        transform_b=jnp.asarray(g["transform_b"]) if transform else None,
    )


def port_grads(g, tables=("word", "entity"), transform=True, device=None, dtype=None):
    def tensor(x):
        return torch.from_numpy(x).to(device, dtype)

    def desc(x):
        grad, idx, w = x
        return tobj.SparseGrad(tensor(grad), torch.from_numpy(idx).long().to(device),
                               None if w is None else tensor(w))

    return tobj.AscentGrads(
        word=tuple(desc(x) for x in g["word_list"]) if "word_list" in g else
        ((desc(g["word"]),) if "word" in tables else ()),
        entity=(desc(g["entity"]),) if "entity" in tables else (),
        transform_w=tensor(g["transform_w"]) if transform else None,
        transform_b=tensor(g["transform_b"]) if transform else None,
    )


def assert_same(j, t):
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)


def assert_same_state(jstate, tstate):
    assert [type(s).__name__ for s in jstate] == [type(s).__name__ for s in tstate]
    for js, ts in zip(jstate, tstate):
        assert js._fields == ts._fields
        for j, t in zip(js, ts):
            if np.asarray(j).dtype.kind == "i":
                np.testing.assert_array_equal(to_np(t), np.asarray(j))
            else:
                assert_same(j, t)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_steps_from_nonzero_state_match_jax(name, lam, lr):
    cfg = cfg_for(name, lr, lam)
    jopt, topt = jupd.Optimizer(twin(cfg)), tupd.Optimizer(cfg)
    p = np_params(1)
    jp = JModelParams(*(jnp.asarray(x) for x in p))
    tp = params_from_numpy(p)
    jstate = nonzero_state(jopt.init(jp), 2)
    tstate = tupd.opt_state_from_numpy(jstate)
    for step in range(3):
        g = np_grads(seed=10 + step)
        jp, jstate = jopt.apply(jp, jstate, jax_grads(g), lr, lam)
        out_p, out_s = topt.apply(tp, tstate, port_grads(g), lr, lam)
        assert out_p is tp and out_s is tstate  # in place
    for j, t in zip(jp, tp):
        assert_same(j, t)
    assert_same_state(jstate, tstate)
    if name in ("sparse_adam", "dense_adam", "full_adam"):
        assert int(tstate.word.t) == int(tstate.transform.t) == 8


@pytest.mark.parametrize("name", ["sparse_adam", "dense_adam"])
def test_sparse_moments_decay_every_row(name):
    """Rows no descriptor touches still decay: m by beta1, v by beta2
    (updates_adam.cu:196-252)."""
    cfg = cfg_for(name)
    jp = JModelParams(*(jnp.asarray(x) for x in np_params(3)))
    state = tupd.opt_state_from_numpy(nonzero_state(jupd.Optimizer(twin(cfg)).init(jp), 4))
    before = tupd.opt_state_to_numpy(state)
    g = np_grads(seed=5)
    untouched = sorted(set(range(NUM_WORDS)) - set(g["word"][1].ravel()))
    assert untouched
    tupd.Optimizer(cfg).apply(params_from_numpy(np_params(3)), state, port_grads(g), 0.5, 0.1)
    np.testing.assert_allclose(state.word.m.numpy()[untouched], BETA1 * before.word.m[untouched],
                               rtol=1e-15)
    np.testing.assert_allclose(state.word.v.numpy()[untouched], BETA2 * before.word.v[untouched],
                               rtol=1e-15)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_no_descriptors_and_no_transform_leave_them_unchanged(name):
    """A similarity step gives one table's descriptors and no transform
    gradients: the other table (no decay fold either), the transform and
    their state stay as they were, in both packages."""
    cfg = cfg_for(name)
    jopt = jupd.Optimizer(twin(cfg))
    p = np_params(6)
    jp = JModelParams(*(jnp.asarray(x) for x in p))
    jstate = nonzero_state(jopt.init(jp), 7)
    tp, tstate = params_from_numpy(p), tupd.opt_state_from_numpy(jstate)
    g = np_grads(seed=8)
    jp, jstate = jopt.apply(jp, jstate, jax_grads(g, ("entity",), False), 0.5, 0.1)
    tupd.Optimizer(cfg).apply(tp, tstate, port_grads(g, ("entity",), False), 0.5, 0.1)
    np.testing.assert_array_equal(tp.word_reprs.numpy(), p.word_reprs)
    np.testing.assert_array_equal(tp.transform_w.numpy(), p.transform_w)
    np.testing.assert_array_equal(tp.transform_b.numpy(), p.transform_b)
    assert not np.array_equal(tp.entity_reprs.numpy(), p.entity_reprs)
    for j, t in zip(jp, tp):
        assert_same(j, t)
    assert_same_state(jstate, tstate)


@pytest.mark.parametrize("name", ["adagrad", "sparse_adam"])
def test_both_packages_refuse_multiple_descriptors(name):
    """CHECK_EQ(gradient_descs->size(), 1) (updates_adagrad.cu:108,
    updates_adam.cu:348)."""
    cfg = cfg_for(name)
    g = np_grads()
    g["word_list"] = (g["word"], g["word"])
    jp = JModelParams(*(jnp.asarray(x) for x in np_params()))
    jopt = jupd.Optimizer(twin(cfg))
    with pytest.raises(AssertionError, match="multiple gradients"):
        jopt.apply(jp, jopt.init(jp), jax_grads(g, ("word",), False), 0.5, 0.0)
    tp = params_from_numpy(np_params())
    topt = tupd.Optimizer(cfg)
    with pytest.raises(ValueError, match="multiple gradients"):
        topt.apply(tp, topt.init(tp), port_grads(g, ("word",), False), 0.5, 0.0)


@pytest.mark.parametrize("name", ["sgd", "dense_adam", "full_adam"])
def test_multiple_descriptors_accumulate_like_jax(name):
    cfg = cfg_for(name)
    g = np_grads(seed=9)
    g["word_list"] = (g["word"], np_grads(seed=19)["word"])
    jopt = jupd.Optimizer(twin(cfg))
    jp = JModelParams(*(jnp.asarray(x) for x in np_params(9)))
    jstate = nonzero_state(jopt.init(jp), 9)
    tp, tstate = params_from_numpy(np_params(9)), tupd.opt_state_from_numpy(jstate)
    jp, jstate = jopt.apply(jp, jstate, jax_grads(g), 0.5, 0.1)
    tupd.Optimizer(cfg).apply(tp, tstate, port_grads(g), 0.5, 0.1)
    for j, t in zip(jp, tp):
        assert_same(j, t)
    assert_same_state(jstate, tstate)


def test_helpers_match_jax():
    """The one slot scatter, in its table and its scalar form, with and
    without weights and a scale, against JAX's ``_scatter_add`` and
    ``_scatter_add_scalar``; the window-mean gather against JAX's."""
    rng = np.random.RandomState(11)
    idx = rng.randint(0, 5, (7, 3)).astype(np.int32)
    w = rng.rand(7, 3) + 0.5
    grad = rng.randn(7, 4)
    table = rng.randn(5, 4)
    vec = rng.randn(5)
    vals = rng.randn(7)
    for weights, scale in ((w, 0.3), (None, 0.7), (None, None)):
        jd = jobj.SparseGrad(jnp.asarray(grad), jnp.asarray(idx),
                             None if weights is None else jnp.asarray(weights))
        td = tobj.SparseGrad(torch.from_numpy(grad), torch.from_numpy(idx).long(),
                             None if weights is None else torch.from_numpy(weights))
        jscale = 1.0 if scale is None else scale
        t = torch.from_numpy(table.copy())
        assert sk.scatter_add_slots(t, td, scale) is t
        assert_same(jupd._scatter_add(jnp.asarray(table), jd, jscale), t)
        v = torch.from_numpy(vec.copy())
        assert sk.scatter_add_slots(v, td._replace(grad=torch.from_numpy(vals)), scale) is v
        assert_same(jupd._scatter_add_scalar(jnp.asarray(vec), jd, jnp.asarray(vals), jscale), v)
    for arr in (table, vec):
        assert_same(jupd._window_mean_gather(jnp.asarray(arr), jnp.asarray(idx)),
                    tupd._window_mean_gather(torch.from_numpy(arr), torch.from_numpy(idx).long()))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_opt_state_round_trips_for_every_kind(name):
    jp = JModelParams(*(jnp.asarray(x) for x in np_params()))
    jstate = nonzero_state(jupd.Optimizer(twin(cfg_for(name))).init(jp), 12)
    tstate = tupd.opt_state_from_numpy(jstate)
    back = tupd.opt_state_to_numpy(tstate)
    assert_same_state(jstate, tstate)
    for js, ts, bs in zip(jstate, tstate, back):
        assert type(bs) is type(ts)
        for j, b in zip(js, bs):
            np.testing.assert_array_equal(b, np.asarray(j))
    if name == "sgd":
        assert all(len(s) == 0 for s in tstate)


# ---------------------------------------------------------------------------
# Closed forms (tests/test_optim.py:96-314), held to the port.
# ---------------------------------------------------------------------------


def np_scatter(shape, grad, idx, w):
    out = np.zeros(shape)
    w = np.ones(idx.shape) if w is None else w
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            out[idx[i, j]] += w[i, j] * grad[i]
    return out


def run_port(name, lr, lam, seed=0):
    p, g = np_params(), np_grads(seed)
    opt = tupd.Optimizer(cfg_for(name, lr, lam))
    tp = params_from_numpy(p)
    state = opt.init(tp)
    opt.apply(tp, state, port_grads(g), lr, lam)
    return p, g, tp, state


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_sgd_closed_form(lam, lr):
    p, g, new, _ = run_port("sgd", lr, lam)
    want_w = p.word_reprs * (1 - lam * lr) + lr * np_scatter((NUM_WORDS, D_W), *g["word"])
    np.testing.assert_allclose(new.word_reprs.numpy(), want_w, rtol=1e-12)
    want_e = p.entity_reprs * (1 - lam * lr) + lr * np_scatter((NUM_ENTITIES, D_E), *g["entity"])
    np.testing.assert_allclose(new.entity_reprs.numpy(), want_e, rtol=1e-12)
    want_t = p.transform_w * (1 - lam * lr) + lr * g["transform_w"]
    np.testing.assert_allclose(new.transform_w.numpy(), want_t, rtol=1e-12)
    # The bias is never regularized (storage.cu:222-227).
    np.testing.assert_allclose(new.transform_b.numpy(), p.transform_b + lr * g["transform_b"],
                               rtol=1e-12)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adagrad_closed_form(lam, lr):
    p, g, new, state = run_port("adagrad", lr, lam)
    gw = g["transform_w"]
    want = p.transform_w * (1 - lam * lr) + lr * gw / np.sqrt(gw**2 + EPS)
    np.testing.assert_allclose(new.transform_w.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(state.transform.acc_w.numpy(), gw**2, rtol=1e-12)
    grad, idx, w = g["word"]
    msq = np.mean(grad**2, axis=1)
    acc = np.zeros(NUM_WORDS)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            acc[idx[i, j]] += w[i, j] * msq[i]
    agg = np.array([acc[idx[i]].mean() for i in range(idx.shape[0])])
    scaled = grad / np.sqrt(agg + EPS)[:, None]  # eps inside the sqrt
    want = p.word_reprs * (1 - lam * lr) + lr * np_scatter((NUM_WORDS, D_W), scaled, idx, w)
    np.testing.assert_allclose(new.word_reprs.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(state.word.acc.numpy(), acc, rtol=1e-12)


def _sparse_moments(g):
    grad, idx, w = g["word"]
    m = (1 - BETA1) * np_scatter((NUM_WORDS, D_W), grad, idx, w)
    msq = np.mean(grad**2, axis=1)
    v = np.zeros(NUM_WORDS)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            v[idx[i, j]] += (1 - BETA2) * w[i, j] * msq[i]
    return m, v, np.sqrt(1 - BETA2) / (1 - BETA1)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_sparse_adam_closed_form(lam, lr):
    p, g, new, state = run_port("sparse_adam", lr, lam)
    m, v, bc = _sparse_moments(g)
    _, idx, w = g["word"]
    agg_m = np.stack([m[idx[i]].mean(axis=0) for i in range(idx.shape[0])])
    agg_v = np.array([v[idx[i]].mean() for i in range(idx.shape[0])])
    step = bc * agg_m / (np.sqrt(agg_v)[:, None] + EPS)  # eps outside the sqrt
    want = p.word_reprs * (1 - lam * lr) + lr * np_scatter((NUM_WORDS, D_W), step, idx, w)
    np.testing.assert_allclose(new.word_reprs.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(state.word.m.numpy(), m, rtol=1e-12)
    np.testing.assert_allclose(state.word.v.numpy(), v, rtol=1e-12)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_dense_update_adam_closed_form(lam, lr):
    p, g, new, _ = run_port("dense_adam", lr, lam)
    m, v, bc = _sparse_moments(g)
    want = p.word_reprs * (1 - lam * lr) + lr * bc * m / (np.sqrt(v)[:, None] + EPS)
    np.testing.assert_allclose(new.word_reprs.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_full_adam_closed_form(lam, lr):
    p, g, new, _ = run_port("full_adam", lr, lam)
    scattered = np_scatter((NUM_WORDS, D_W), *g["word"])
    pw = p.word_reprs
    m = (1 - BETA1) * scattered - (1 - BETA1) * lam * pw
    v = (1 - BETA2) * (scattered - lam * pw) ** 2
    bc = np.sqrt(1 - BETA2) / (1 - BETA1)
    np.testing.assert_allclose(new.word_reprs.numpy(), pw + lr * bc * m / (np.sqrt(v) + EPS),
                               rtol=1e-10)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adam_transform_two_steps_closed_form(lam, lr):
    p = np_params()
    opt = tupd.Optimizer(cfg_for("sparse_adam", lr, lam))
    tp = params_from_numpy(p)
    state = opt.init(tp)
    w, m, v = p.transform_w, np.zeros_like(p.transform_w), np.zeros_like(p.transform_w)
    for t in (1, 2):
        g = np_grads(seed=t)
        opt.apply(tp, state, port_grads(g), lr, lam)
        gw = g["transform_w"] - lam * w
        m = BETA1 * m + (1 - BETA1) * gw
        v = BETA2 * v + (1 - BETA2) * gw**2
        w = w + lr * np.sqrt(1 - BETA2**t) / (1 - BETA1**t) * m / (np.sqrt(v) + EPS)
        np.testing.assert_allclose(tp.transform_w.numpy(), w, rtol=1e-10)
    assert int(state.transform.t) == 3
