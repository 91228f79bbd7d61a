"""``check_gradients`` under a mesh: four gloo ranks at 2x2 (float64, the
CPU), held to the single-device check.

* one check of each objective kind and negative layout of
  ``tests/test_torch_trainer_options.py`` (N 5, padded to 6 rows on the
  model axis) on the same parameters, batch and draws: the same
  (num_checked, max_relative_error) as the single-device check within
  1e-9, on every rank;
* ``train_model(mesh=, check_gradients=True)`` host-fed and with a
  composite: a check before every step on every rank, the first held to
  one device's within 1e-9, the training equal to one device's;
* the JAX trainer's own check under its 2x2 mesh runs on the same corpus
  and counts the same entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.train import gradcheck as jgradcheck
from cunvsm_torch.config import DataConfig, ModelDesc
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.train import gradcheck
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train import trainer as ttrainer
from tests.test_torch_trainer import cfg, small_corpus
from tests.test_torch_trainer_options import CPU, GRAD_CASES, NUM_ENTITIES, _grad_case
from tests.torch_parity import twin

torch.set_num_threads(1)
K = tstep.ObjectiveKind


MESH_DESC = ModelDesc(word_repr_size=3, entity_repr_size=2)
MESH_TRAIN_CASES = ("host_fed", "composite")


def _mesh_train_inputs(path):
    """(corpus, cfg, kwargs) of the trainer run that ``path`` checks."""
    from cunvsm_torch.data.sources import SimilaritySource

    corpus = small_corpus(docs_per_topic=2, doc_len=10)
    if path == "host_fed":
        return corpus, cfg(1, batch=4), {}
    ids = np.random.RandomState(0).randint(0, corpus.num_docs, (16, 2)).astype(np.int32)
    source = SimilaritySource(ids, np.ones(16, np.float32), 4, seed=1)
    c = cfg(1, batch=4, text_entity_weight=0.7, entity_entity_weight=0.3)
    return corpus, c, dict(similarity_source=source)


def _mesh_batch_scenario(name):
    """One check of ``GRAD_CASES[name]``'s parameters (N 5, padded to 6
    rows on a model axis of 2) and batch."""
    kind, desc, c, arrays, batches = _grad_case(name)
    te, sim = batches("torch") if kind in tstep.COMPOSITES else (None, None)
    one = batches("torch")
    if kind == K.TEXT_ENTITY:
        te = one
    elif kind in (K.ENTITY_ENTITY, K.TERM_TERM):
        sim = one
    batch = {}
    if te is not None:
        batch.update(features=te.features.numpy(), feature_weights=te.feature_weights.numpy(),
                     labels=te.labels.numpy(), weights=te.weights.numpy())
    if sim is not None:
        batch.update(ids=sim.ids.numpy(), sim_weights=sim.weights.numpy())
    return dict(name=f"batch_{name}", run="gradcheck", kind=kind.value, desc=desc, cfg=c,
                params=ModelParams(*arrays), batch=batch, num_entities=NUM_ENTITIES,
                generator_seed=5)


@pytest.fixture(scope="module")
def mesh_gradchecks(tmp_path_factory):
    """Every scenario's checks on the ranks of one 2x2 spawn."""
    from tests.test_torch_parallel import spawn_ranks

    outdir = str(tmp_path_factory.mktemp("mesh_gradcheck"))
    spec = [_mesh_batch_scenario(name) for name in sorted(GRAD_CASES)]
    for path in MESH_TRAIN_CASES:
        corpus, c, kw = _mesh_train_inputs(path)
        spec.append(dict(name=f"train_{path}", run="gradcheck", desc=MESH_DESC, cfg=c,
                         corpus=corpus, kwargs=kw))
    spawn_ranks("2x2", spec, outdir)
    return outdir


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_check_gradients_under_a_2x2_mesh_matches_one_device(mesh_gradchecks, case):
    """The mesh's analytic gradients, fetched to full tables, against
    central differences of the global cost, on four gloo ranks: the same
    (num_checked, max_relative_error) as the single-device check of the
    same parameters, batch and draws, within 1e-9, on every rank."""
    from tests.test_torch_parallel import load_rank

    kind, desc, c, arrays, batches = _grad_case(case)
    params = ModelParams(*(torch.from_numpy(a.copy()) for a in arrays))
    n, err = gradcheck.check_gradients(kind, params, batches("torch"),
                                       torch.Generator().manual_seed(5), CPU, desc, c)
    for rank in range(4):
        (got,) = load_rank(mesh_gradchecks, f"batch_{case}", rank)["checks"]
        assert got[0] == n == sum(a.size for a in arrays)
        assert abs(got[1] - err) <= 1e-9, (rank, got[1], err)


def _single_device_checks(path, monkeypatch):
    corpus, c, kw = _mesh_train_inputs(path)
    calls = []
    check = gradcheck.check_gradients

    def recording(*args, **kwargs):
        calls.append(check(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(gradcheck, "check_gradients", recording)
    result = ttrainer.train_model(MESH_DESC, c, corpus, CPU, dtype=torch.float64,
                                  check_gradients=True, **kw)
    return np.asarray(calls, dtype=np.float64), result.epoch_costs


@pytest.mark.parametrize("path", MESH_TRAIN_CASES)
def test_train_model_checks_every_step_under_a_mesh(mesh_gradchecks, monkeypatch, path):
    """``train_model(mesh=, check_gradients=True)`` (host-fed,
    steps_per_call=1) checks before every step on every rank and trains
    what one device trains.  The first check sees the single-device
    check's parameters and batch and is held to it within 1e-9; later
    checks see tables that differ from one device's in the last bits,
    which moves a finite difference's rounding, so they are held to the
    count and the pass."""
    from tests.test_torch_parallel import load_rank

    want, costs = _single_device_checks(path, monkeypatch)
    assert len(want) > 1 and (want[:, 1] < 1e-4).all()
    for rank in range(4):
        got = load_rank(mesh_gradchecks, f"train_{path}", rank)
        assert got["checks"].shape == want.shape
        np.testing.assert_array_equal(got["checks"][:, 0], want[:, 0])
        assert abs(got["checks"][0, 1] - want[0, 1]) <= 1e-9
        assert (got["checks"][:, 1] < 1e-4).all()
        np.testing.assert_allclose(got["costs"], costs, rtol=1e-12)


def test_jax_trainer_checks_gradients_under_its_mesh(monkeypatch):
    """The JAX trainer's own check runs under its 2x2 mesh (host-fed,
    steps_per_call=1) and counts the entries of the full tables, as the
    port's mesh check does; its random streams are its own, so only the
    count and the pass are compared.  (A corpus of short documents keeps
    its per-step recompilations few.)"""
    from cunvsm_tpu.data.corpus import build_corpus as jbuild_corpus
    from cunvsm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from cunvsm_tpu.train.trainer import train_model as jtrain_model
    from tests.test_torch_slice import synthetic_corpus

    docs, _ = synthetic_corpus(num_docs_per_topic=2, doc_len=5)
    data_cfg = DataConfig(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0)
    jcorpus = jbuild_corpus(docs, twin(data_cfg), window_size=4)
    corpus = small_corpus(docs_per_topic=2, doc_len=5)
    assert (jcorpus.vocab.size, jcorpus.num_docs) == (corpus.vocab.size, corpus.num_docs)
    calls = []
    check = jgradcheck.check_gradients

    def recording(*args, **kwargs):
        calls.append(check(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(jgradcheck, "check_gradients", recording)
    jtrain_model(twin(MESH_DESC), twin(cfg(1, batch=4)), jcorpus, check_gradients=True,
                 dtype=jnp.float64, mesh=jmake_mesh(2, 2))
    d_w, d_e = MESH_DESC.word_repr_size, MESH_DESC.entity_repr_size
    full = corpus.vocab.size * d_w + corpus.num_docs * d_e + d_w * d_e + d_e
    assert calls and {n for n, _ in calls} == {full}
    assert max(err for _, err in calls) < 1e-4
