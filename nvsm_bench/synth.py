"""Inputs made from ``--seed``: the synthetic collection's tokens.

The token draw is a frozen copy of ``cunvsm_torch/data/synth.py:zipf_corpus``
(the inverse CDF of a Zipf law over the vocabulary's ranks), drawn on the
device in one call.  Everything here depends on the seed and the sizes
alone, so two runs of one seed get the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def program_seed(seed: int) -> int:
    """The seed handed to the program's ``TrainConfig.seed``: a positive
    32-bit number, since the host batch source seeds numpy's RandomState,
    which takes no more; distinct ``--seed`` values give distinct ones."""
    return int(np.random.SeedSequence(seed).generate_state(1, np.uint32)[0]) | 1


def zipf_cdf(vocab_size: int, exponent: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** exponent
    return np.cumsum(p / p.sum())


def zipf_tokens(seed: int, count: int, vocab_size: int, exponent: float,
                device) -> np.ndarray:
    """``count`` Zipf-distributed token ids (id = frequency rank), int32 on
    the host, drawn on ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cdf = torch.as_tensor(zipf_cdf(vocab_size, exponent), device=device)
    u = torch.rand(count, generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u).clamp_(max=vocab_size - 1)
    return ids.to(torch.int32).cpu().numpy()

