"""Plain PyTorch NVSM / LSE training over the first epochs: the reference
of the training cells.

The model (TOIS 2018 §3; CIKM 2016 for LSE): the window mean of the word
vectors, projected (x @ W), batch-normalized with gamma 1 and the bias as
beta (NVSM) or biased (LSE), through hard_tanh or tanh; NCE over the
positive document and k negatives with the sigmoid clipped to [1e-7,
1 - 1e-7], the negative-sampling weights of ``bias_negative_samples`` off
(positive k (k+1)/2k, negatives (k+1)/2k) or on (all 1), the cost summed
and divided by the batch.  Gradients by autograd.  Both tables under
full_adam: the ascent gradient minus (lambda / B) times the table feeds
both moments, the step is lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) +
eps); the transform under Adam with (lambda / B) on W alone.

The negatives are the configuration's rolled pool: P ids drawn per step,
instance b (residue b // (B / P)) scoring pool slots (r + j * stride) % P,
P the largest of 2048, 1024, ..., 64 that divides B and covers at most a
quarter of the collection, the stride about P / k, odd, with k distinct
slots.

Streams: where the configuration states bfloat16 streams, the word rows,
the window sum and mean, the entity rows and the projections are rounded
to bfloat16 on the way forward, and the gradient rows that reach the
tables (per window slot, per positive, per pool row) are rounded on the
way back; the tables, moments and every sum stay float32.

The draws follow the port's documented random streams of on-device
sampling, so that the reference trains on the batches the program trains
on: one generator on the device, seeded with the seed for the Glorot init
(words, documents, transform), reseeded from ``derived_seed(seed,
0x5A5A5A, epoch)`` for the epoch's shuffle of the document pointers and
from ``derived_seed(seed, 1, steps so far)`` before each call of K steps
(the epoch's last call may be shorter), whose steps draw their window
placements and then their pool.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

PERMUTATION_STREAM = 0x5A5A5A
STEP_STREAM = 1
POOL_CANDIDATES = (2048, 1024, 512, 256, 128, 64)
POOL_MAX_COVERAGE = 0.25
SIGMOID_EPS = 1e-7
BN_EPS = 1e-4
LEAVES = ("word_reprs", "entity_reprs", "transform_w", "transform_b")


def derived_seed(seed: int, stream: int, counter: int) -> int:
    state = np.random.SeedSequence([seed, stream, counter]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def pool_layout(batch: int, k: int, num_docs: int):
    """(P, stride) of the automatic rolled pool, or (0, 1) for none."""
    p = next((c for c in POOL_CANDIDATES if batch % c == 0 and c >= k), 0)
    if not p or p > POOL_MAX_COVERAGE * num_docs:
        return 0, 1
    s = max(p // k, 1)
    s = (s + 1 if s % 2 == 0 else s) % p or 1
    while len({(j * s) % p for j in range(k)}) != k:
        s += 2
    return p, s


class _RoundForward(torch.autograd.Function):
    """Rounds the values to ``dtype``; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    """Passes the values; rounds the gradient to ``dtype``."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def stream(x, dtype):
    """A stream of ``dtype``: rounded forward and its gradient rounded."""
    if dtype is None:
        return x
    return _RoundBackward.apply(_RoundForward.apply(x, dtype), dtype)


def rounded(x, dtype):
    return x if dtype is None else _RoundForward.apply(x, dtype)


class Spec(NamedTuple):
    vocab: int
    docs: int
    doc_len: int
    word_dim: int
    entity_dim: int
    batch: int
    window: int
    k: int
    lam: float
    lr: float
    hard_tanh: bool
    batch_norm: bool
    bias_negative_samples: bool
    stream_dtype: Optional[torch.dtype]
    window_sum_stream: bool  # the window sum and mean at stream width

    @classmethod
    def from_config(cls, cfg: dict, stream_override: Optional[str] = None) -> "Spec":
        m, t, c = cfg["model"], cfg["train"], cfg["collection"]
        name = stream_override or t.get("stream_dtype", "float32")
        dtype = None if name == "float32" else getattr(torch, name)
        return cls(
            vocab=c["vocab_size"], docs=c["num_docs"], doc_len=c["doc_len"],
            word_dim=m["word_repr_size"], entity_dim=m["entity_repr_size"],
            batch=t["batch_size"], window=t["window_size"], k=t["num_random_entities"],
            lam=t["regularization_lambda"], lr=t["learning_rate"],
            hard_tanh=m["nonlinearity"] == "hard_tanh",
            batch_norm=m["batch_normalization"],
            bias_negative_samples=m["bias_negative_samples"],
            stream_dtype=dtype,
            window_sum_stream=dtype is not None
            and t.get("window_sum_dtype") == t.get("stream_dtype"),
        )

    def samples_per_doc(self) -> int:
        return max(int(math.ceil(self.doc_len - self.window + 1)), 1)

    def steps_per_epoch(self) -> int:
        return self.docs * self.samples_per_doc() // self.batch


def init_tables(seed: int, spec: Spec, device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform words, documents, transform from one generator seeded
    with ``seed``; zero bias."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def glorot(rows, cols):
        limit = (6.0 / (rows + cols)) ** 0.5
        out = torch.empty((rows, cols), dtype=torch.float32, device=device)
        return out.uniform_(-limit, limit, generator=gen)

    return dict(
        word_reprs=glorot(spec.vocab, spec.word_dim),
        entity_reprs=glorot(spec.docs, spec.entity_dim),
        transform_w=glorot(spec.word_dim, spec.entity_dim),
        transform_b=torch.zeros(spec.entity_dim, dtype=torch.float32, device=device),
    )


def _windows(tokens, starts, window):
    return tokens[starts[:, None] + torch.arange(window, device=tokens.device)[None, :]]


def device_sampled_batches(tokens, seed, spec: Spec, steps_per_call: int, gen, epoch: int,
                           steps: Optional[int] = None):
    """Epoch ``epoch``'s (features, labels, pool ids) under on-device
    sampling, or its first ``steps``; ``tokens`` [docs * doc_len] int64 on
    the device."""
    device = tokens.device
    per_epoch = spec.steps_per_epoch()
    k = min(steps_per_call, per_epoch)
    steps = per_epoch if steps is None else steps
    pool, _ = pool_layout(spec.batch, spec.k, spec.docs)
    ptrs = torch.arange(spec.docs, device=device).repeat_interleave(spec.samples_per_doc())
    gen.manual_seed(derived_seed(seed, PERMUTATION_STREAM, epoch))
    perm = ptrs[torch.randperm(ptrs.shape[0], generator=gen, device=device)]
    max_pos = spec.doc_len - spec.window + 1
    for t in range(steps):
        if t % k == 0:
            gen.manual_seed(derived_seed(seed, STEP_STREAM, (epoch - 1) * per_epoch + t))
        docs = perm[t * spec.batch:(t + 1) * spec.batch]
        u = torch.rand(spec.batch, generator=gen, device=device, dtype=torch.float32)
        pos = torch.clamp(torch.floor(u * float(max_pos)).to(torch.int64), max=max_pos - 1)
        features = _windows(tokens, docs * spec.doc_len + pos, spec.window)
        pool_ids = torch.randint(0, spec.docs, (pool,), generator=gen, device=device)
        yield features, docs, pool_ids


def loss(tables, features, labels, pool_ids, spec: Spec, rows: Optional[int] = None):
    """The NCE cost of one batch with the rolled pool; ``rows`` keeps only
    the first rows of the batch in the cost (a fault for the checks)."""
    dt = spec.stream_dtype
    word, ent, w, b = (tables[n] for n in LEAVES)
    x = stream(word[features], dt)  # [B, W, d_w]
    summed = x.sum(dim=1)
    if spec.window_sum_stream:
        phrase = rounded(rounded(summed, dt) / spec.window, dt)
    else:
        phrase = summed / spec.window
    h = phrase @ w
    if spec.batch_norm:
        mean = h.mean(dim=0, keepdim=True)
        var = torch.square(h - mean).mean(dim=0, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + BN_EPS) + b
    else:
        h = h + b
    a = rounded(torch.clamp(h, -1.0, 1.0) if spec.hard_tanh else torch.tanh(h), dt)
    pool, stride = pool_layout(spec.batch, spec.k, spec.docs)
    pos_rows = stream(ent[labels], dt)
    pool_rows = stream(ent[pool_ids], dt)
    residue = torch.arange(spec.batch, device=a.device) // (spec.batch // pool)
    slots = (residue[:, None] + stride * torch.arange(spec.k, device=a.device)[None, :]) % pool
    pos = (a * pos_rows).sum(dim=-1)
    neg = torch.einsum("bd,bkd->bk", a, pool_rows[slots])
    dots = torch.cat([pos[:, None], -neg], dim=1)
    k = spec.k
    if not spec.bias_negative_samples and k > 1:
        wts = torch.full((k + 1,), (k + 1.0) / (2.0 * k), device=a.device)
        wts[0] *= k
    else:
        wts = torch.ones(k + 1, device=a.device)
    p = torch.clamp(torch.sigmoid(dots), SIGMOID_EPS, 1.0 - SIGMOID_EPS)
    rows = spec.batch if rows is None else rows
    return -(wts[None, :] * torch.log(p[:rows])).sum() / rows


class Adam:
    """full_adam on both tables, Adam on the transform."""

    def __init__(self, tables, spec: Spec, beta1=0.9, beta2=0.999, eps=1e-6):
        self.spec, self.beta1, self.beta2, self.eps = spec, beta1, beta2, eps
        self.m = {n: torch.zeros_like(t) for n, t in tables.items()}
        self.v = {n: torch.zeros_like(t) for n, t in tables.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, tables, ascent):
        self.t += 1
        lam = self.spec.lam / self.spec.batch
        b1, b2 = self.beta1, self.beta2
        bc = torch.sqrt(1.0 - torch.tensor(b2, dtype=torch.float32) ** self.t) / (
            1.0 - torch.tensor(b1, dtype=torch.float32) ** self.t)
        scale = (self.spec.lr * bc).to(tables["word_reprs"].device)
        for n in LEAVES:
            agg = ascent[n] if n == "transform_b" else ascent[n] - lam * tables[n]
            self.m[n].mul_(b1).add_((1.0 - b1) * agg)
            self.v[n].mul_(b2).add_((1.0 - b2) * torch.square(agg))
            tables[n].add_(scale * self.m[n] / (torch.sqrt(self.v[n]) + self.eps))


class Followed(NamedTuple):
    init: Dict[str, torch.Tensor]
    after: List[Dict[str, torch.Tensor]]  # the tables after each epoch
    costs: List[List[float]]  # each epoch's step costs
    first_grad_norms: Dict[str, float]


def follow(tokens: np.ndarray, seed: int, spec: Spec, steps_per_call: int, device,
           epochs: int, steps: Optional[int] = None, rows: Optional[int] = None) -> Followed:
    """Train the first ``epochs`` epochs (or ``steps`` steps of each) from
    the seed, as the configuration states; the tables before and after each
    epoch, each step's cost and the norm of each leaf's first gradient.
    ``rows`` is ``loss``'s."""
    tok = torch.as_tensor(tokens, device=device).to(torch.int64)
    tables = init_tables(seed, spec, device)
    init = {n: t.clone() for n, t in tables.items()}
    opt = Adam(tables, spec)
    gen = torch.Generator(device=device)
    after, costs, first = [], [], {}
    for epoch in range(1, epochs + 1):
        costs.append([])
        for features, labels, pool_ids in device_sampled_batches(
                tok, seed, spec, steps_per_call, gen, epoch, steps):
            leaves = {n: t.detach().requires_grad_(True) for n, t in tables.items()}
            cost = loss(leaves, features, labels, pool_ids, spec, rows)
            grads = torch.autograd.grad(cost, [leaves[n] for n in LEAVES])
            ascent = {n: -g for n, g in zip(LEAVES, grads)}
            if not first:
                first = {n: float(torch.linalg.vector_norm(g.double()))
                         for n, g in ascent.items()}
            opt.update(tables, ascent)
            costs[-1].append(float(cost.detach()))
            del leaves, grads, ascent, cost
        after.append({n: t.clone() for n, t in tables.items()})
    return Followed(init, after, costs, first)
