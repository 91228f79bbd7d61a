"""A plain PyTorch Mix 'n Match step (Van Gysel, de Rijke, Kanoulas, CIKM
2018): the reference that the port's composite objectives are held to.

It imports nothing of ``cunvsm_torch`` and nothing of JAX: every quantity
is worked out again from the paper's definitions, in the dtype of the
tables handed in (float64 in the tests), with gradients by autograd.

* The text part, NVSM's (TOIS 2018): the window mean of the word vectors,
  projected (x @ W), batch-normalized over the batch with gamma 1 and the
  bias as beta (epsilon 1e-4), through hard_tanh or tanh; NCE over the
  positive document and the k given negatives with the sigmoid clipped to
  [1e-7, 1 - 1e-7], the negatives' dots negated, the slots weighted (k + 1)
  / 2k and the positive k times that, each instance by its weight, the sum
  divided by the batch.
* The similarity part: for each pair, log of the clipped sigmoid of the dot
  of its two rows of one table (the entity table for
  TEXT_ENTITY_ENTITY_ENTITY, the word table for TEXT_ENTITY_TERM_TERM),
  weighted, the sum negated and divided by the pairs.
* The composite: the reported cost is the mean of the two costs, and the
  step ascends (w_t c_t + w_s c_s) / (w_t + w_s), the weighted merge of the
  two gradients.
* full_adam: for each table the ascent gradient minus (lambda / B) times
  the table feeds both moments (beta1 0.9, beta2 0.999), and the table
  moves by lr sqrt(1 - beta2^t) / (1 - beta1^t) m / (sqrt(v) + 1e-6); the
  transform's W takes the same decay, its bias none.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

LEAVES = ("word_reprs", "entity_reprs", "transform_w", "transform_b")
SIGMOID_EPS = 1e-7
BN_EPS = 1e-4


class Spec(NamedTuple):
    table: str  # "entity" or "word": the table that the pairs index
    text_weight: float
    similarity_weight: float
    lam: float  # lambda, divided by the text batch in the update
    lr: float
    hard_tanh: bool = True
    batch_norm: bool = True
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6


def _log_p(dots):
    return torch.log(torch.clamp(torch.sigmoid(dots), SIGMOID_EPS, 1.0 - SIGMOID_EPS))


def text_cost(tables, features, labels, negatives, weights, spec: Spec):
    """The NCE cost of a text batch: ``features`` [B, W] word ids,
    ``labels`` [B] documents, ``negatives`` [B, k] documents, ``weights``
    [B]."""
    word, ent, w, b = (tables[n] for n in LEAVES)
    h = word[features].mean(dim=1) @ w
    if spec.batch_norm:
        mean = h.mean(dim=0, keepdim=True)
        var = torch.square(h - mean).mean(dim=0, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + BN_EPS) + b
    else:
        h = h + b
    a = torch.clamp(h, -1.0, 1.0) if spec.hard_tanh else torch.tanh(h)
    pos = (a * ent[labels]).sum(dim=-1)
    neg = torch.einsum("bd,bkd->bk", a, ent[negatives])
    k = negatives.shape[1]
    slot = torch.full((k + 1,), (k + 1.0) / (2.0 * k), dtype=a.dtype)
    slot[0] *= k
    log_p = _log_p(torch.cat([pos[:, None], -neg], dim=1))
    return -(weights.to(a.dtype)[:, None] * slot[None, :] * log_p).sum() / features.shape[0]


def similarity_cost(tables, ids, weights, spec: Spec):
    """The similarity cost of ``ids`` [B, 2] rows of the spec's table."""
    table = tables["entity_reprs" if spec.table == "entity" else "word_reprs"]
    dots = (table[ids[:, 0]] * table[ids[:, 1]]).sum(dim=-1)
    return -(weights.to(table.dtype) * _log_p(dots)).sum() / ids.shape[0]


class Adam:
    """full_adam over both tables and Adam over the transform."""

    def __init__(self, tables: Dict[str, torch.Tensor], spec: Spec):
        self.spec = spec
        self.m = {n: torch.zeros_like(t) for n, t in tables.items()}
        self.v = {n: torch.zeros_like(t) for n, t in tables.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, tables, ascent, batch_size: int):
        s = self.spec
        self.t += 1
        lam = s.lam / batch_size
        scale = s.lr * (1.0 - s.beta2 ** self.t) ** 0.5 / (1.0 - s.beta1 ** self.t)
        for n in LEAVES:
            agg = ascent[n] if n == "transform_b" else ascent[n] - lam * tables[n]
            self.m[n].mul_(s.beta1).add_((1.0 - s.beta1) * agg)
            self.v[n].mul_(s.beta2).add_((1.0 - s.beta2) * torch.square(agg))
            tables[n].add_(scale * self.m[n] / (torch.sqrt(self.v[n]) + s.eps))


def step(tables, opt: Adam, text, pairs, spec: Spec) -> float:
    """One composite step in place on ``tables`` and ``opt``: ``text`` is
    (features, labels, negatives, weights), ``pairs`` (ids, weights).
    Returns the reported cost."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in tables.items()}
    c_text = text_cost(leaves, *text, spec)
    c_sim = similarity_cost(leaves, *pairs, spec)
    total = spec.text_weight + spec.similarity_weight
    optimized = (spec.text_weight * c_text + spec.similarity_weight * c_sim) / total
    grads = torch.autograd.grad(optimized, [leaves[n] for n in LEAVES])
    opt.update(tables, {n: -g for n, g in zip(LEAVES, grads)}, text[0].shape[0])
    return float(0.5 * (c_text + c_sim).detach())
