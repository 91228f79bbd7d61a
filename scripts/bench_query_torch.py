#!/usr/bin/env python3
"""Query-serving latency benchmark on the PyTorch port (``cunvsm_torch``):
``scripts/bench_query.py`` with its inputs, flags and printed lines.

Brute-force cosine top-k over a collection-scale document matrix through
the port's scoring function (``cunvsm_torch.query.engine._rank_kernel``,
zero bias, no nonlinearity: the JAX script's inline ``serve``), with a
float32 and a bfloat16 document matrix, for 1 and 16 queries.  Each
configuration runs once to warm up, then ``--iters`` calls back to back
between one pair of CUDA events (on the CPU: the host clock).

    python3 scripts/bench_query_torch.py [--docs 262144] [--dim 256] \\
        [--top_k 1000] [--iters 50] [--device cpu]
    python3 scripts/bench_query_torch.py --qlm

``--qlm`` runs the collection-scale QLM ranker (``query/qlm.py``, on the
host) over a Robust04-sized synthetic index instead.  ``--device``
(default ``cuda``) picks the device; without a card the script fails
unless it is given ``--device cpu``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cunvsm_torch.cli.train import add_device_flag, resolve_device  # noqa: E402
from cunvsm_torch.query.engine import _rank_kernel  # noqa: E402
from cunvsm_torch.query.qlm import QLMIndex, qlm_rank  # noqa: E402


def bench_qlm(num_docs=500_000, vocab=65536, avg_len=200, queries=50, seed=0):
    """Collection-scale QLM+PRF benchmark (Robust04-sized synthetic corpus):
    the postings-based scorer touches only nonzeros."""
    import scipy.sparse

    rng = np.random.RandomState(seed)
    # Zipf-ish term distribution, ~avg_len distinct terms per doc.
    nnz = num_docs * 60
    rows = rng.randint(0, num_docs, nnz)
    terms = (vocab * rng.power(0.25, nnz)).astype(np.int64) % vocab
    counts = rng.randint(1, 5, nnz).astype(np.float64)
    mat = scipy.sparse.coo_matrix((counts, (rows, terms)), shape=(num_docs, vocab)).tocsr()
    cf = np.asarray(mat.sum(axis=0)).ravel()
    index = QLMIndex(
        doc_term=mat,
        doc_lengths=np.asarray(mat.sum(axis=1)).ravel(),
        collection_prob=cf / max(cf.sum(), 1.0),
        docnos=[str(i) for i in range(num_docs)],
        term_to_id={f"t{i}": i for i in range(vocab)},
    )
    qs = {str(q): [f"t{t}" for t in rng.randint(0, vocab, 4)] for q in range(queries)}
    index.doc_term_csc  # build outside the timing
    for smoothing, prf in (("jm", False), ("jm", True), ("dirichlet", True)):
        t0 = time.time()
        run = qlm_rank(index, qs, smoothing=smoothing, prf=prf)
        dt = time.time() - t0
        print(f"qlm {smoothing} prf={prf}: {1000*dt/len(qs):.1f} ms/query "
              f"({num_docs} docs, {len(run)} queries)")


def serve_inputs(docs, dim, word_dim, device):
    """The JAX script's inputs: ``RandomState(0)``, a row-normalized
    float32 E [docs, dim], then W [word_dim, dim]; returns (E as numpy, W
    on ``device``, the generator, which draws the queries next)."""
    rng = np.random.RandomState(0)
    E = rng.randn(docs, dim).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    W = torch.as_tensor(rng.randn(word_dim, dim).astype(np.float32), device=device)
    return E, W, rng


def serve(queries, E, W, zero_bias, top_k):
    """(scores, indices) of the top ``top_k`` documents for each query
    (cosines of the normalized ``queries @ W`` with the rows of ``E``)."""
    return _rank_kernel(queries, W, zero_bias, E, top_k, None)


def time_ms(fn, iters, device) -> float:
    """Mean ms of ``iters`` calls back to back after one warm-up."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1000


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--docs", type=int, default=262144)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--word_dim", type=int, default=300)
    p.add_argument("--top_k", type=int, default=1000)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--qlm", action="store_true",
                   help="run the collection-scale QLM ranker benchmark (host)")
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.qlm:
        bench_qlm()
        return 0
    device = resolve_device(args.device)
    E, W, rng = serve_inputs(args.docs, args.dim, args.word_dim, device)
    zero_bias = torch.zeros(args.dim, device=device)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        Emat = torch.as_tensor(E, device=device).to(dtype)
        for Q in (1, 16):
            qs = torch.as_tensor(rng.randn(Q, args.word_dim).astype(np.float32), device=device)
            dt = time_ms(lambda: serve(qs, Emat, W, zero_bias, args.top_k), args.iters, device)
            print(f"E {tag} Q={Q:3d}: {dt:7.3f} ms/serve ({dt / Q * 1000:8.1f} us/query) "
                  f"top-{args.top_k} over {args.docs} docs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
