"""The mesh layer on the card: a process group of one rank with NCCL and a
1x1 mesh over it.

Every collective of the wrapper runs as a real NCCL call on CUDA tensors
(float32, bfloat16 and int64), is counted by name and, unlike a gloo group
given CUDA tensors, is not staged through the host; ``fetch`` returns the
shard of the only rank; the autograd form of the all-reduce goes through
``torch.func.vjp``; the sharded scorer over the one shard equals the dense
ranking; and one mesh step at a small size equals the single-device step
from the same draws.  The four-rank runs are ``chip_smoke.py``'s phase H2
(``scripts/mesh_phase_torch.py``).
"""

import numpy as np
import pytest
import torch

from cunvsm_torch.config import AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig, UpdateMethod
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.models.params import init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.parallel import distributed, mesh as pmesh
from cunvsm_torch.parallel.query import make_sharded_scorer
from cunvsm_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    device = torch.device("cuda", 0)
    distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="nccl",
                           device=device, timeout=120.0)
    distributed.reset_collective_log()
    try:
        yield pmesh.make_mesh(1, 1), device
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_collectives_run_through_nccl_and_are_counted(nccl_mesh, dtype):
    mesh, device = nccl_mesh
    x = torch.arange(24, device=device).reshape(6, 4).to(dtype)
    for axis in ("data", "model", None):
        reduced = mesh.all_reduce(x.clone(), axis, "reduce")
        assert torch.equal(reduced, x)
        gathered = mesh.all_gather(x, axis, "gather", dim=1)
        assert torch.equal(gathered, x)
    log = distributed.collective_log()
    nbytes = x.numel() * x.element_size()
    assert log["reduce"] == dict(op="all_reduce", calls=3, bytes=3 * nbytes,
                                 staged_through_host=False)
    assert log["gather"] == dict(op="all_gather", calls=3, bytes=3 * nbytes,
                                 staged_through_host=False)
    assert torch.equal(distributed.fetch(x), x)
    assert distributed.is_primary() and distributed.process_count() == 1


def test_nccl_refuses_a_cpu_tensor(nccl_mesh):
    with pytest.raises(RuntimeError, match="no collective for a CPU tensor"):
        distributed.all_reduce(torch.ones(3), "x")


def test_all_reduce_grad_goes_through_vjp(nccl_mesh):
    mesh, device = nccl_mesh
    x = torch.randn(5, 3, device=device)

    def f(t):
        return (mesh.all_reduce_grad(t.sum(0), "data", "stat") ** 2).sum()

    value, vjp = torch.func.vjp(f, x)
    (grad,) = vjp(torch.ones_like(value))
    torch.testing.assert_close(grad, (2 * x.sum(0)).expand_as(x))
    log = distributed.collective_log()
    assert log["stat"]["calls"] == 1 and log["stat_grad"]["calls"] == 1


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
def test_sharded_scorer_equals_the_dense_ranking(nccl_mesh, score_dtype):
    mesh, device = nccl_mesh
    gen = torch.Generator(device=device).manual_seed(3)
    e = torch.nn.functional.normalize(torch.randn(5000, 64, generator=gen, device=device))
    q = torch.nn.functional.normalize(torch.randn(7, 64, generator=gen, device=device))
    e, q = e.to(score_dtype), q.to(score_dtype)
    scorer, shard = make_sharded_scorer(mesh, e, 100)
    assert shard.shape == e.shape
    scores, ids = scorer(q)
    dense = q.to(torch.float32) @ e.to(torch.float32).T
    want_scores, want_ids = torch.topk(dense, 100, dim=1)
    torch.testing.assert_close(scores, want_scores, rtol=0, atol=1e-5)
    gaps = (want_scores[:, :-1] - want_scores[:, 1:]).abs() > 2e-5
    distinct = torch.ones_like(want_ids, dtype=torch.bool)
    distinct[:, 1:] &= gaps
    distinct[:, :-1] &= gaps
    assert torch.equal(ids[distinct], want_ids[distinct]) and distinct.float().mean() > 0.9
    log = distributed.collective_log()
    assert log["topk_scores"]["bytes"] == 7 * 100 * 4 and log["topk_ids"]["bytes"] == 7 * 100 * 8


def test_mesh_step_equals_the_single_device_step(nccl_mesh):
    """Three canonical-layout steps (pooled, bfloat16 streams, float32
    reduce) at a small size: the 1x1 mesh step against the plain step from
    the same draws, within float32 rounding of another order of sums."""
    mesh, device = nccl_mesh
    V, N, B, W = 512, 4096, 1024, 10
    desc = ModelDesc(word_repr_size=32, entity_repr_size=16,
                     nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True)
    cfg = TrainConfig(
        batch_size=B, window_size=W, num_random_entities=10, update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE), learning_rate=1e-3,
        stream_dtype="bfloat16", uniform_feature_weights=True, negative_pool_size=256,
        cross_chip_reduce_dtype="float32",
    )
    rng = np.random.RandomState(0)
    batches = [TextEntityBatch(
        torch.from_numpy(rng.randint(0, V, (B, W))).to(device), torch.ones((B, W), device=device),
        torch.from_numpy(rng.randint(0, N, B)).to(device), torch.ones(B, device=device),
    ) for _ in range(3)]
    results = []
    for use_mesh in (False, True):
        gen = torch.Generator(device=device).manual_seed(5)
        params = init_params(gen, V, N, desc, device=device)
        state = Optimizer(cfg).init(params)
        if use_mesh:
            step, params, state = pmesh.make_sharded_train_step(
                desc, cfg, mesh, params, state, device, gen)
        else:
            step = make_train_step(desc, cfg, device, gen, num_entities=N)
        costs = [float(step(params, state, b)) for b in batches]
        results.append((costs, params))
    (c0, p0), (c1, p1) = results
    np.testing.assert_allclose(c1, c0, rtol=1e-5)
    for a, b in zip(pmesh.fetch_params(mesh, p1, N), p0):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6)
    log = distributed.collective_log()
    assert log["word_partial"]["calls"] == 3 and log["word_partial"]["bytes"] == 3 * V * 32 * 4
