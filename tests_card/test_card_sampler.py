"""The on-device sampler and the K-step call on the card against the CPU."""

import numpy as np
import pytest
import torch

from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.instances import FeatureWeighting, Weighting
from cunvsm_torch.data.vocab import Vocabulary
from cunvsm_torch.models.params import params_from_numpy
from cunvsm_torch.optim import updates as tupd
from tests_card.card_parity import B, DESCS, V, W, numpy_params, train_config

WEIGHTINGS = {
    "uniform": (Weighting.UNIFORM, FeatureWeighting.UNIFORM),
    "inv_doc_frequency": (Weighting.INV_DOC_FREQUENCY, FeatureWeighting.UNIFORM),
    "self_information": (Weighting.UNIFORM, FeatureWeighting.SELF_INFORMATION),
}


def uneven_corpus(num_docs=48, seed=0, max_len=20):
    """num_docs documents of 1..max_len-1 tokens over V words; the docs
    shorter than the window W are not eligible."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, max_len, num_docs)
    tokens = rng.randint(0, V, int(lengths.sum())).astype(np.int32)
    freq = np.bincount(tokens, minlength=V).astype(np.int64)
    vocab = Vocabulary(
        terms=[f"t{i}" for i in range(V)], term_to_id={f"t{i}": i for i in range(V)},
        term_freq=freq, total_terms=int(freq.sum()), include_oov=False,
        index_term_ids=np.arange(V, dtype=np.int64),
    )
    return Corpus(
        vocab=vocab, tokens=tokens,
        doc_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        index_lengths=lengths.astype(np.int64),
        docnos=[f"d{i}" for i in range(num_docs)], window_size=W,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
def test_sample_batch_on_card_matches_cpu(cuda, weighting):
    corpus = uneven_corpus()
    w, fw = WEIGHTINGS[weighting]
    cpu_dc = tds.prepare_device_corpus(corpus, "cpu", weighting=w, feature_weighting=fw)
    card_dc = tds.prepare_device_corpus(corpus, cuda, weighting=w, feature_weighting=fw)
    perm = tds.make_epoch_permuter(card_dc)[0](torch.Generator(device=cuda).manual_seed(0))
    docs = perm[:B]
    u = torch.rand(B, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    got = tds.sample_batch(card_dc, B, docs=docs, uniforms=u)
    want = tds.sample_batch(cpu_dc, B, docs=docs.cpu(), uniforms=u.cpu())
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if x is not None:
            assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
def test_multistep_on_card_matches_cpu(cuda):
    """Three float32 steps on the card (the kernels) against the same
    steps in float64 on the CPU (the plain versions), injected draws."""
    corpus = uneven_corpus(num_docs=60, seed=4)
    desc, cfg = DESCS["nvsm"], train_config(negative_pool_size=8, uniform_feature_weights=True)
    np_params = numpy_params(21)._replace(entity_reprs=np.random.RandomState(22).uniform(
        -0.5, 0.5, (corpus.num_docs, desc.entity_repr_size)))
    perm = np.random.RandomState(23).permutation(
        tds.epoch_doc_pointers(tds.prepare_device_corpus(corpus, "cpu")).numpy())
    rng = np.random.RandomState(24)
    draws = [(rng.uniform(0, 1, B).astype(np.float32), rng.randint(0, corpus.num_docs, 8))
             for _ in range(3)]
    results = []
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        dc = tds.prepare_device_corpus(corpus, device)
        params = params_from_numpy(np_params, device, dtype)
        state = tupd.Optimizer(cfg).init(params)
        run = tds.make_device_sampled_multistep(desc, cfg, dc, 3, None, num_entities=corpus.num_docs)
        costs = run(params, state, torch.from_numpy(perm).to(device), 0, draws=[
            tds.StepDraws(torch.from_numpy(u).to(device), torch.from_numpy(ids).to(device))
            for u, ids in draws])
        results.append((costs.double().cpu().numpy(), [t.double().cpu().numpy() for t in params]))
    (gc, gp), (cc, cp) = results
    np.testing.assert_allclose(gc, cc, rtol=1e-5)
    for g, c in zip(gp, cp):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)
