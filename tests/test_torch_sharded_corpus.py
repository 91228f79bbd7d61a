"""The port's device corpus sharded over the data axis, held to the JAX
package's and to a single-process emulation of the data groups.

* the host-side layout (``sharded_corpus_arrays``) equals the JAX package's
  ``prepare_sharded_device_corpus`` array for array: the groups'
  ``global_doc_id``, local offsets and lengths, ``inv_doc_weight``, the
  wrap-padded ``local_pointers``, the pointers per epoch, and the re-packed
  tokens (the first 16 columns of JAX's overlapped wide rows);
* with the window placements that JAX's sharded sampler draws injected, the
  sampled batches equal JAX's, group by group;
* a group's shuffle is a permutation of its pointers, so an epoch draws every
  eligible document ``samples_per_doc`` times plus the wrap, and every batch
  holds exactly B/data rows of each group; the stratified single-device
  permuter has that batch composition (and the JAX permuter's size);
* ``train_model(mesh=, shard_corpus=True)`` on four gloo ranks (2x2 and 4x1)
  equals, at rtol 1e-9 in float64, a single process that plays the data
  groups in turn on the single-device step; ``stratify_data_groups`` trains
  end to end.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cunvsm_tpu.data import device_sampler as jds
from cunvsm_tpu.data import instances as jinst
from cunvsm_tpu.parallel import mesh as jmesh
from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.instances import TextEntitySource
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.models.params import init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.parallel import mesh as pmesh
from cunvsm_torch.train import trainer as ttrainer
from cunvsm_torch.train.step import make_train_step
from tests.test_torch_device_sampler import WEIGHTINGS, uneven_corpus
from tests.test_torch_parallel import (
    ATOL, RTOL, TRAIN_DESC, load_rank, spawn_ranks, train_cfg, trainer_corpus,
)
from tests.torch_parity import B, W, to_np

import _torch_distributed_worker as worker

torch.set_num_threads(1)
CPU = torch.device("cpu")
G = jds.WIDE_ROW_STRIDE


def position(data, index):
    """A mesh position of data index ``index`` without a process group."""
    return pmesh.Mesh(data, 1, rank=index)


def both_sharded(corpus, n_data, weighting="uniform"):
    """(JAX ShardedDeviceCorpus, JAX mesh, the port's shard of every data
    index) of one corpus."""
    w, fw = WEIGHTINGS[weighting]
    mesh = jmesh.make_mesh(n_data, 1)
    jsdc = jds.prepare_sharded_device_corpus(
        corpus, mesh, weighting=jinst.Weighting(w.value),
        feature_weighting=jinst.FeatureWeighting(fw.value),
    )
    shards = [
        tds.prepare_sharded_device_corpus(corpus, position(n_data, s), CPU, w, fw)
        for s in range(n_data)
    ]
    return jsdc, mesh, shards


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
@pytest.mark.parametrize("n_data", [2, 4])
def test_sharded_corpus_layout_equals_jax(n_data, weighting):
    corpus = uneven_corpus(num_docs=61, seed=3)
    jsdc, mesh, shards = both_sharded(corpus, n_data, weighting)
    meta = np.asarray(jsdc.doc_meta)
    wide = np.asarray(jsdc.tokens_wide)
    for s, sdc in enumerate(shards):
        assert (sdc.num_shards, sdc.shard, sdc.window_size) == (n_data, s, W)
        np.testing.assert_array_equal(to_np(sdc.doc_offsets), meta[s, :, 0])
        np.testing.assert_array_equal(to_np(sdc.doc_lengths), meta[s, :, 1])
        np.testing.assert_array_equal(to_np(sdc.global_doc_id), np.asarray(jsdc.global_doc_id)[s])
        np.testing.assert_array_equal(to_np(sdc.local_pointers),
                                      np.asarray(jsdc.local_pointers)[s])
        # The flat stream is the first G columns of the overlapped rows.
        flat = wide[s, :, :G].reshape(-1)
        n = sdc.tokens.shape[0]
        np.testing.assert_array_equal(to_np(sdc.tokens), flat[:n])
        assert not flat[n:].any()
        if jsdc.inv_doc_weight is None:
            assert sdc.inv_doc_weight is None
        else:
            np.testing.assert_array_equal(to_np(sdc.inv_doc_weight),
                                          np.asarray(jsdc.inv_doc_weight)[s])
        assert (sdc.term_weights is None) == (jsdc.term_weights_wide is None)
    _, jptrs = jds.make_sharded_epoch_permuter(jsdc, mesh)
    assert tds.make_epoch_permuter(shards[0])[1] == jptrs
    # The groups partition the eligible documents, in order.
    arrays, spd = tds.sharded_corpus_arrays(corpus, n_data)
    docs = np.concatenate([a.global_doc_id[:a.num_docs] for a in arrays])
    np.testing.assert_array_equal(docs, np.flatnonzero(corpus.doc_lengths >= W))
    assert spd == shards[0].samples_per_doc


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
@pytest.mark.parametrize("n_data,cursor", [(2, 0), (4, 8)])
def test_sharded_sampler_equals_jax_on_its_placements(n_data, cursor, weighting):
    """JAX's sharded sampler draws group d's placements from
    ``fold_in(key, d)``; with those injected, the port's groups fetch JAX's
    batch rows: features, feature weights, labels and weights, bitwise."""
    corpus = uneven_corpus(num_docs=61, seed=4)
    jsdc, mesh, shards = both_sharded(corpus, n_data, weighting)
    sampler, b_local = jds._make_sharded_sampler(jsdc, mesh, B)
    key = jax.random.PRNGKey(9)
    jbatch = sampler(key, cursor)
    assert b_local == B // n_data
    for s, sdc in enumerate(shards):
        u = np.array(jax.random.uniform(jax.random.fold_in(key, s), (b_local,)))
        got = tds.sample_sharded_batch(
            sdc, b_local, sdc.local_pointers, cursor, uniforms=torch.from_numpy(u))
        rows = slice(s * b_local, (s + 1) * b_local)
        for field in ("features", "feature_weights", "labels", "weights"):
            np.testing.assert_array_equal(
                to_np(getattr(got, field)), np.asarray(getattr(jbatch, field))[rows], field)


def test_token_balanced_groups_need_enough_documents():
    corpus = uneven_corpus(num_docs=3, seed=1, max_len=W + 1)
    with pytest.raises(ValueError, match="eligible documents < data axis 8"):
        tds.sharded_corpus_arrays(corpus, 8)


@pytest.mark.parametrize("n_data", [2, 4])
def test_a_group_epoch_draws_every_document_its_share(n_data):
    """A group's shuffle permutes its wrap-padded pointers: every eligible
    document of the group is drawn ``samples_per_doc`` times plus the wrap
    (at most ``samples_per_doc`` more), groups shuffle differently and
    reshuffle per seed, and the rows a group contributes are its own
    documents'."""
    corpus = uneven_corpus(num_docs=61, seed=5)
    shards = [tds.prepare_sharded_device_corpus(corpus, position(n_data, s), CPU)
              for s in range(n_data)]
    arrays, spd = tds.sharded_corpus_arrays(corpus, n_data)
    shared = torch.Generator().manual_seed(123)
    perms = []
    for s, sdc in enumerate(shards):
        permute, ptrs = tds.make_epoch_permuter(sdc)
        perm = permute(shared)
        assert ptrs == n_data * perm.shape[0]
        np.testing.assert_array_equal(np.sort(to_np(perm)), np.sort(to_np(sdc.local_pointers)))
        counts = np.bincount(to_np(perm), minlength=arrays[s].num_docs)
        assert counts.shape[0] == arrays[s].num_docs  # no padding row is drawn
        assert ((counts >= spd) & (counts <= 2 * spd)).all()
        assert counts.sum() == perm.shape[0]
        torch.testing.assert_close(permute(shared), perm, rtol=0, atol=0)  # same seed
        assert not torch.equal(permute(torch.Generator().manual_seed(124)), perm)
        perms.append(perm)
        batch = tds.sample_sharded_batch(sdc, B // n_data, perm, 0, torch.Generator().manual_seed(s))
        own = set(arrays[s].global_doc_id[:arrays[s].num_docs].tolist())
        assert batch.labels.shape == (B // n_data,) and set(batch.labels.tolist()) <= own
        lengths = corpus.doc_lengths[to_np(batch.labels)]
        starts = corpus.doc_offsets[to_np(batch.labels)]
        # Every window lies inside its document.
        for row, (start, length) in zip(to_np(batch.features), zip(starts, lengths)):
            doc = corpus.tokens[start:start + length]
            assert any((doc[i:i + W] == row).all() for i in range(length - W + 1))
    if perms[0].shape == perms[1].shape:
        assert not torch.equal(perms[0], perms[1])


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_stratified_permuter_has_the_sharded_batch_composition(groups):
    """``make_stratified_epoch_permuter``: every batch of the flat stream
    holds B/groups consecutive pointers of each group in turn, every
    document is drawn ``samples_per_doc`` times plus the wrap, and the
    stream has the JAX permuter's length."""
    corpus = uneven_corpus(num_docs=97, seed=6)
    jdc = jds.prepare_device_corpus(corpus)
    dc = tds.prepare_device_corpus(corpus, CPU)
    permute, ptrs = tds.make_stratified_epoch_permuter(dc, groups, B)
    _, jptrs = jds.make_stratified_epoch_permuter(jdc, groups, B)
    assert ptrs == jptrs and ptrs % B == 0
    stream = permute(torch.Generator().manual_seed(7))
    assert stream.shape == (ptrs,)
    arrays, spd = tds.sharded_corpus_arrays(corpus, groups)
    blocks = to_np(stream).reshape(-1, groups, B // groups)
    for g, a in enumerate(arrays):
        own = a.global_doc_id[:a.num_docs]
        assert np.isin(blocks[:, g, :], own).all()
        counts = np.bincount(blocks[:, g, :].reshape(-1), minlength=corpus.num_docs)[own]
        assert (counts >= spd).all() and counts.sum() == ptrs // groups
    again = permute(torch.Generator().manual_seed(7))
    assert torch.equal(again, stream)
    assert not torch.equal(permute(torch.Generator().manual_seed(8)), stream)
    with pytest.raises(ValueError, match="batch_size 32 not divisible by num_groups 5"):
        tds.make_stratified_epoch_permuter(dc, 5, B)


def test_stratify_data_groups_trains_end_to_end():
    """The trainer's ``stratify_data_groups``: the stratified epochs train
    (the cost falls), take the stratified permuter's steps and differ from
    the globally shuffled run of the same seed."""
    corpus = trainer_corpus()
    kw = dict(on_device_sampling=True, steps_per_call=2, dtype=torch.float64)
    cfg = train_cfg(4, learning_rate=0.05)
    plain = ttrainer.train_model(TRAIN_DESC, cfg, corpus, CPU, **kw)
    strat = ttrainer.train_model(TRAIN_DESC, cfg, corpus, CPU, stratify_data_groups=2, **kw)
    assert strat.epoch_costs[-1] < strat.epoch_costs[0]
    dc = tds.prepare_device_corpus(corpus, CPU)
    ptrs = tds.make_stratified_epoch_permuter(dc, 2, cfg.batch_size)[1]
    assert strat.steps == 4 * min(plain.steps // 4, ptrs // cfg.batch_size)
    assert not torch.equal(strat.params.entity_reprs, plain.params.entity_reprs)


# ---------------------------------------------------------------------------
# The trainer on a mesh with the corpus sharded.
# ---------------------------------------------------------------------------

SHARD_MESHES = ("2x2", "4x1")
SHARD_KWARGS = dict(on_device_sampling=True, shard_corpus=True, steps_per_call=2)


def shard_scenarios():
    corpus = trainer_corpus()

    def scenario(name, phases):
        return dict(name=name, run="train", desc=TRAIN_DESC, corpus=corpus, phases=phases)

    return [
        scenario("shard", [dict(cfg=train_cfg(2), kwargs=dict(SHARD_KWARGS, output_prefix="s"))]),
        scenario("shard-pooled", [dict(cfg=train_cfg(2, negative_pool_size=4),
                                       kwargs=dict(SHARD_KWARGS))]),
        scenario("shard-resumed", [
            dict(cfg=train_cfg(1), kwargs=dict(SHARD_KWARGS, output_prefix="r")),
            dict(cfg=train_cfg(2), kwargs=dict(SHARD_KWARGS, output_prefix="r", resume=True)),
        ]),
    ]


@pytest.fixture(scope="module", params=SHARD_MESHES)
def shard_run(request, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp(f"shard_{request.param}"))
    spawn_ranks(request.param, shard_scenarios(), outdir)
    return request.param, outdir


def play_data_groups(desc, cfg, corpus, n_data, steps_per_call):
    """One process in the place of the mesh: the data groups' shards, their
    generators and their shuffles, played in turn, their rows concatenated
    into the global batch of the single-device step.  Follows the trainer's
    seeding: the shared generator is reseeded per epoch (the shuffles) and
    per call (the steps); a group's generator takes its seed from the
    shared one's and the group's index."""
    cfg = dataclasses.replace(cfg, uniform_feature_weights=True)
    generator = torch.Generator().manual_seed(cfg.seed)
    params = init_params(generator, corpus.vocab.size, corpus.num_docs, desc,
                         dtype=torch.float64, device=CPU)
    state = Optimizer(cfg).init(params)
    shards = [tds.prepare_sharded_device_corpus(corpus, position(n_data, g), CPU)
              for g in range(n_data)]
    permuters = [tds.make_epoch_permuter(sdc) for sdc in shards]
    source = TextEntitySource(corpus, batch_size=cfg.batch_size, seed=cfg.seed)
    steps_epoch = max(min(source.batches_per_epoch(), permuters[0][1] // cfg.batch_size), 1)
    k = min(steps_per_call, steps_epoch)
    calls = [k] * (steps_epoch // k) + ([steps_epoch % k] if steps_epoch % k else [])
    step = make_train_step(desc, cfg, CPU, generator, num_entities=corpus.num_docs)
    b_local = cfg.batch_size // n_data
    group_gens = [torch.Generator() for _ in range(n_data)]
    total, epoch_costs = 0, []
    for epoch in range(1, cfg.num_epochs + 1):
        generator.manual_seed(ttrainer.derived_seed(cfg.seed, ttrainer.PERMUTATION_STREAM, epoch))
        perms = [permute(generator) for permute, _ in permuters]
        cursor, costs = 0, []
        for n in calls:
            generator.manual_seed(ttrainer.derived_seed(cfg.seed, ttrainer.STEP_STREAM, total))
            for g, gen in enumerate(group_gens):
                gen.manual_seed(tds.derived_seed(generator.initial_seed(), tds.GROUP_STREAM, g))
            for i in range(n):
                parts = [
                    tds.sample_sharded_batch(shards[g], b_local, perms[g],
                                             cursor // n_data + i * b_local, group_gens[g])
                    for g in range(n_data)
                ]
                batch = TextEntityBatch(*(torch.cat(f) for f in list(zip(*parts))[:4]))
                costs.append(float(step(params, state, batch)))
            cursor += n * cfg.batch_size
            total += n
        epoch_costs.append(float(np.mean(costs)))
    return params, state, epoch_costs, total


@pytest.mark.parametrize("name", ["shard", "shard-pooled", "shard-resumed"])
def test_sharded_corpus_training_equals_the_played_groups(shard_run, name):
    shape, outdir = shard_run
    data, model = pmesh.parse_mesh_shape(shape)
    sc = {s["name"]: s for s in shard_scenarios()}[name]
    got = load_rank(outdir, name)
    last = len(sc["phases"]) - 1
    params, state, costs, steps = play_data_groups(
        sc["desc"], sc["phases"][-1]["cfg"], sc["corpus"], data, 2)
    np.testing.assert_allclose(
        np.concatenate([got[f"p{i}_costs"] for i in range(last + 1)]), costs, rtol=RTOL)
    assert sum(int(got[f"p{i}_steps"]) for i in range(last + 1)) == steps > 0
    num_docs = sc["corpus"].num_docs
    for key, value in worker.state_arrays(f"p{last}_", params, state).items():
        have = got[key]
        if have.ndim and have.shape[0] != value.shape[0]:
            have = have[:num_docs]
        np.testing.assert_allclose(have, value, rtol=RTOL, atol=ATOL, err_msg=key)
    # Every rank of a data group fetched the same tables.
    other = load_rank(outdir, name, rank=3)
    np.testing.assert_array_equal(other[f"p{last}_entity_reprs"], got[f"p{last}_entity_reprs"])


def test_sharded_corpus_refusals():
    """The one runner refuses, layout by layout: a shard prepared for
    another mesh position or without a mesh, a batch that does not split
    over every device of the mesh (corpus sharded or replicated), and on
    one device a call without the shuffled pointers."""
    corpus = trainer_corpus()
    sdc = tds.prepare_sharded_device_corpus(corpus, position(2, 1), CPU)

    def runner(dc, mesh):
        return tds.make_device_sampled_multistep(
            TRAIN_DESC, train_cfg(1), dc, 1, torch.Generator(), corpus.num_docs, mesh=mesh)

    with pytest.raises(ValueError, match="not prepared for this mesh position"):
        runner(sdc, position(2, 0))
    with pytest.raises(ValueError, match="a sharded corpus needs the mesh"):
        runner(sdc, None)
    with pytest.raises(ValueError, match=r"batch_size 8 not divisible by the total device "
                                         r"count 3 \(mesh \{'data': 3, 'model': 1\}\)"):
        runner(sdc, position(3, 0))
    dc = tds.prepare_device_corpus(corpus, CPU)
    with pytest.raises(ValueError, match="the sharded word accumulation splits the update "
                                         "stream over every mesh axis"):
        runner(dc, position(3, 0))
    with pytest.raises(ValueError, match="shuffled pointers"):
        runner(dc, None)(None, None)
    with pytest.raises(ValueError, match="stratify_data_groups simulates"):
        ttrainer.train_model(TRAIN_DESC, train_cfg(1), corpus, CPU, on_device_sampling=True,
                             shard_corpus=True, stratify_data_groups=2, mesh=pmesh.Mesh(1, 1))
