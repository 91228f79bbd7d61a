"""The port's activations and batch norm against the JAX package, float64.

Values and gradients (vector-Jacobian products with a random cotangent),
including the eps-mask boundary of the surrogate sigmoid gradient and
hard_tanh at exactly +-1.  hard_tanh and the gradient masks agree bitwise.
``exp`` and ``log`` differ by an ulp between XLA:CPU and PyTorch, and the
reductions (L2 norm, batch statistics) add in another order, so those
values are held to a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.ops import activations as ja
from cunvsm_tpu.ops.batchnorm import batch_norm_train as j_bn
from cunvsm_torch.ops import activations as ta
from cunvsm_torch.ops.batchnorm import batch_norm_train as t_bn

torch.set_num_threads(1)

# Around sigmoid(x) = 1 - 1e-6 (x ~ 13.8155) and 1e-7 (x ~ -16.118), the
# forward clip and the backward mask.
X = np.concatenate([
    np.linspace(-40, 40, 81),
    [13.8155, 13.81551, 13.8156, -13.8155, -13.81551, -13.8156],
    [16.118, 16.1181, -16.118, -16.1181, 0.0, -0.0, 1e-300, -1e-300],
])


def _vjp_pair(jfn, tfn, *arrays, seed=0):
    g = np.random.RandomState(seed).randn(*jfn(*map(jnp.asarray, arrays)).shape)
    jout, jvjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jgrads = jvjp(jnp.asarray(g))
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(g))
    return (
        np.asarray(jout), tout.detach().numpy(),
        [np.asarray(x) for x in jgrads], [x.numpy() for x in tgrads],
    )


@pytest.mark.parametrize("eps_f,eps_b", [(1e-7, 1e-6), (0.0, 0.0)])
def test_log_truncated_sigmoid_matches(eps_f, eps_b):
    jo, to, jg, tg = _vjp_pair(
        lambda x: ja.log_truncated_sigmoid(x, eps_f, eps_b),
        lambda x: ta.log_truncated_sigmoid(x, eps_f, eps_b),
        X,
    )
    np.testing.assert_allclose(to, jo, rtol=1e-15, atol=0)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-15, atol=0)
    np.testing.assert_array_equal(tg[0] == 0.0, jg[0] == 0.0)
    if eps_b:
        # The mask zeroes the gradient past the backward epsilon.
        assert np.all(tg[0][np.abs(X) >= 13.8156] == 0.0)
        assert np.all(tg[0][np.abs(X) <= 13.8155] != 0.0)


@pytest.mark.parametrize("eps", [1e-7, 0.0])
def test_sigmoids_match(eps):
    np.testing.assert_allclose(
        ta.stable_sigmoid(torch.from_numpy(X)).numpy(),
        np.asarray(ja.stable_sigmoid(jnp.asarray(X))), rtol=1e-15, atol=0,
    )
    t = ta.truncated_sigmoid(torch.from_numpy(X), eps).numpy()
    j = np.asarray(ja.truncated_sigmoid(jnp.asarray(X), eps))
    np.testing.assert_allclose(t, j, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(t == eps, j == eps)


def test_hard_tanh_equal_at_the_closed_interval():
    x = np.array([-2.0, -1.0 - 2**-52, -1.0, -0.5, 0.0, 0.5, 1.0, 1.0 + 2**-52, 2.0])
    jo, to, jg, tg = _vjp_pair(ja.hard_tanh, ta.hard_tanh, x)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg[0], jg[0])
    g = np.random.RandomState(0).randn(len(x))
    inside = (x >= -1.0) & (x <= 1.0)
    np.testing.assert_array_equal(tg[0], np.where(inside, g, 0.0))


def test_l2_normalize_rows_close():
    x = np.random.RandomState(1).randn(9, 7)
    x[3] = 0.0  # a zero-weight padding row normalizes to zero
    jo, to, jg, tg = _vjp_pair(ja.l2_normalize_rows, ta.l2_normalize_rows, x)
    np.testing.assert_allclose(to, jo, rtol=1e-15, atol=0)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-13, atol=1e-15)
    assert np.all(to[3] == 0.0)


@pytest.mark.parametrize("rows", [2, 32, 257])
def test_batch_norm_close(rows):
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, 8) * 3 + 1
    beta = rng.randn(8)
    jo, to, jg, tg = _vjp_pair(
        lambda a, b: j_bn(a, b, 1e-4), lambda a, b: t_bn(a, b, 1e-4), x, beta
    )
    np.testing.assert_allclose(to, jo, rtol=1e-13, atol=1e-14)
    for j, t in zip(jg, tg):
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-13)


def test_custom_gradients_under_torch_func_vjp():
    """The objective differentiates through torch.func.vjp; the custom
    backward rules must hold there too."""
    x = torch.from_numpy(X)
    g = torch.from_numpy(np.random.RandomState(2).randn(len(X)))
    _, vjp = torch.func.vjp(lambda t: ta.log_truncated_sigmoid(t, 1e-7, 1e-6), x)
    _, jvjp = jax.vjp(lambda t: ja.log_truncated_sigmoid(t, 1e-7, 1e-6), jnp.asarray(X))
    np.testing.assert_allclose(
        vjp(g)[0].numpy(), np.asarray(jvjp(jnp.asarray(g.numpy()))[0]), rtol=1e-15, atol=0
    )
    _, vjp = torch.func.vjp(ta.hard_tanh, x)
    _, jvjp = jax.vjp(ja.hard_tanh, jnp.asarray(X))
    np.testing.assert_array_equal(vjp(g)[0].numpy(), np.asarray(jvjp(jnp.asarray(g.numpy()))[0]))
