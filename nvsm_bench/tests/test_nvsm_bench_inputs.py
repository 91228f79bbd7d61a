"""Inputs come from the seed: the same seed gives the same inputs, another
seed other inputs."""

import numpy as np
import torch

from nvsm_bench import synth
from nvsm_bench.reference import train as ref

BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def test_program_seed_fits_numpy_and_differs():
    seeds = {synth.program_seed(s) for s in (1, 2, 3, BIG, BIG + 1)}
    assert len(seeds) == 5
    for s in seeds:
        assert 0 < s < 2**32
        np.random.RandomState(s)


def test_zipf_tokens_reproducible():
    a = synth.zipf_tokens(BIG, 5000, 512, 1.07, torch.device("cpu"))
    b = synth.zipf_tokens(BIG, 5000, 512, 1.07, torch.device("cpu"))
    c = synth.zipf_tokens(BIG + 1, 5000, 512, 1.07, torch.device("cpu"))
    assert a.dtype == np.int32 and a.shape == (5000,)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert 0 <= a.min() and a.max() < 512
    counts = np.bincount(a, minlength=512)
    assert counts[0] > counts[10] > counts[200]  # rank 0 is the most frequent


def test_zipf_tokens_follow_the_frozen_law():
    cdf = synth.zipf_cdf(512, 1.07)
    tokens = synth.zipf_tokens(7, 200_000, 512, 1.07, torch.device("cpu"))
    freq = np.bincount(tokens, minlength=512) / len(tokens)
    assert abs(freq[0] - cdf[0]) < 0.005


def test_reference_draws_reproducible():
    spec = ref.Spec(vocab=64, docs=1024, doc_len=12, word_dim=8, entity_dim=4, batch=128,
                    window=4, k=3, lam=0.01, lr=1e-3, hard_tanh=True, batch_norm=True,
                    bias_negative_samples=False, stream_dtype=None, window_sum_stream=False)
    tokens = torch.arange(1024 * 12) % 64
    gen = torch.Generator()

    def draws(seed, epoch):
        return [tuple(t.clone() for t in b)
                for b in ref.device_sampled_batches(tokens, seed, spec, 3, gen, epoch, 4)]

    a, b, c, d = draws(11, 1), draws(11, 1), draws(12, 1), draws(11, 2)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    for other in (c, d):
        assert not all(torch.equal(x, y) for p, q in zip(a, other) for x, y in zip(p, q))
    features, labels, pool = a[0]
    assert features.shape == (128, 4) and labels.shape == (128,)
    # every window is a run of its own document's tokens
    start = (features[:, 0] - labels * 12) % 64
    assert int(start.max()) <= 12 - 4
    rows = labels[:, None] * 12 + start[:, None] + torch.arange(4)[None, :]
    assert torch.equal(features, tokens[rows])
    assert int(pool.max()) < 1024 and pool.shape == (128,)  # P 128, a 1/8 cover
