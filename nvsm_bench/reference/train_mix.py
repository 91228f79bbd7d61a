"""Plain PyTorch Mix 'n Match training over the first epochs: the reference
of the composite training cells.

Mix 'n Match (Van Gysel, de Rijke, Kanoulas, CIKM 2018) trains NVSM's text
objective (``reference/train.py``: the model, its rolled pool of negatives,
its streams, its draws) together with the representation similarity of
substitute products, on one entity table.  Per step:

* the text cost c_t of a batch of B windows, as ``train.loss`` has it;
* the similarity cost c_s of B pairs (i, j) with weights w:
  -(sum w log clamp(sigmoid(<e_i, e_j>), 1e-7, 1 - 1e-7)) / B, the pairs'
  rows at stream width where the configuration states bfloat16 streams;
* the step's reported cost is the mean (c_t + c_s) / 2, and its gradients
  those of (w_t c_t + w_s c_s) / (w_t + w_s) (the weighted merge);
* full_adam on both tables and Adam on the transform, as ``train.Adam``.

The pairs follow the port's documented on-device stream: pass p is
``torch.randperm(n)`` on the device from a generator of the stream's own,
seeded with ``derived_seed(seed, 3, p)``; global step t takes the pairs at
``perm[j B : (j + 1) B]`` of pass ``t // (n // B)``, j = ``t % (n // B)``,
the remainder of each pass dropped.  The text stream's draws are those of
the text-entity run of the seed (``train.device_sampled_batches``).

Nothing here imports the program; TF32 stays off, as the harness sets it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nvsm_bench.reference import train as ref

PAIR_STREAM = 3


class Pairs:
    """The pair stream of a run: ``ids`` [n, 2] int64 and ``weights`` [n]
    float32 on the device."""

    def __init__(self, ids, weights, batch: int, seed: int):
        self.ids, self.weights, self.batch, self.seed = ids, weights, batch, seed
        self.per_pass = ids.shape[0] // batch
        self.gen = torch.Generator(device=ids.device)
        self._pass, self._perm = None, None

    def at(self, step: int, frozen: bool = False):
        """(ids, weights) of global step ``step``; ``frozen`` takes step 0's
        pairs at every step (a fault for the checks)."""
        p, j = divmod(0 if frozen else step, self.per_pass)
        if p != self._pass:
            self.gen.manual_seed(ref.derived_seed(self.seed, PAIR_STREAM, p))
            self._perm = torch.randperm(self.ids.shape[0], generator=self.gen,
                                        device=self.ids.device)
            self._pass = p
        sel = self._perm[j * self.batch:(j + 1) * self.batch]
        return self.ids[sel], self.weights[sel]


def similarity_loss(tables, ids, weights, spec: ref.Spec):
    ent = tables["entity_reprs"]
    rows = ref.stream(ent[ids], spec.stream_dtype)  # [B, 2, d]
    dots = (rows[:, 0] * rows[:, 1]).sum(dim=-1)
    p = torch.clamp(torch.sigmoid(dots), ref.SIGMOID_EPS, 1.0 - ref.SIGMOID_EPS)
    return -(weights * torch.log(p)).sum() / ids.shape[0]


def follow(tokens: np.ndarray, pair_ids: np.ndarray, pair_weights: np.ndarray, seed: int,
           spec: ref.Spec, weights, steps_per_call: int, device, epochs: int,
           steps: Optional[int] = None, drop_similarity: bool = False,
           frozen_pairs: bool = False) -> ref.Followed:
    """Train the first ``epochs`` epochs (or the first ``steps`` steps of
    epoch 1, with ``epochs`` 1) from the seed as the configuration states;
    ``weights`` is (text weight, similarity weight).  The tables before and
    after each epoch, each step's reported cost and the norm of each leaf's
    first gradient.  ``drop_similarity`` trains the text part
    alone (the reported cost unchanged), ``frozen_pairs`` trains the first
    pair batch at every step: faults for the checks."""
    w_text, w_sim = weights
    tok = torch.as_tensor(tokens, device=device).to(torch.int64)
    pairs = Pairs(torch.as_tensor(pair_ids, device=device).to(torch.int64),
                  torch.as_tensor(pair_weights, device=device).to(torch.float32),
                  spec.batch, seed)
    tables = ref.init_tables(seed, spec, device)
    init = {n: t.clone() for n, t in tables.items()}
    opt = ref.Adam(tables, spec)
    gen = torch.Generator(device=device)
    after, costs, first = [], [], {}
    step = 0
    for epoch in range(1, epochs + 1):
        costs.append([])
        for features, labels, pool_ids in ref.device_sampled_batches(
                tok, seed, spec, steps_per_call, gen, epoch, steps):
            leaves = {n: t.detach().requires_grad_(True) for n, t in tables.items()}
            c_text = ref.loss(leaves, features, labels, pool_ids, spec)
            c_sim = similarity_loss(leaves, *pairs.at(step, frozen_pairs), spec)
            sim_part = 0.0 if drop_similarity else w_sim
            optimized = (w_text * c_text + sim_part * c_sim) / (w_text + sim_part)
            grads = torch.autograd.grad(optimized, [leaves[n] for n in ref.LEAVES])
            ascent = {n: -g for n, g in zip(ref.LEAVES, grads)}
            if not first:
                first = {n: float(torch.linalg.vector_norm(g.double()))
                         for n, g in ascent.items()}
            opt.update(tables, ascent)
            costs[-1].append(float(0.5 * (c_text + c_sim).detach()))
            step += 1
            del leaves, grads, ascent, c_text, c_sim, optimized
        after.append({n: t.clone() for n, t in tables.items()})
    return ref.Followed(init, after, costs, first)

