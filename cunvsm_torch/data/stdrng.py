"""Bit-exact twins of the libstdc++ RNG machinery the CUDA reference trains
with, for opt-in reference-RNG replay.

Copied from ``cunvsm_tpu.data.stdrng`` (pure Python and numpy): the
reference-RNG replay of this package draws the same stream.

The reference's host RNG is ``std::minstd_rand0``
(include/cuNVSM/base.h:36), consumed through three libstdc++
algorithms whose outputs are implementation-defined by the C++ standard but
fixed for libstdc++ (the toolchain the reference builds under):

* ``std::uniform_int_distribution`` — negative labels (cpp/labels.cu:3-22 via
  cuda_utils.h:24-33 ``generate_random_indexes``) and per-document window
  positions (cpp/data_indri.cpp:385-388);
* ``std::shuffle`` — the per-epoch instance-pointer shuffle
  (cpp/data_indri.cpp:397), including libstdc++'s paired-swap fast path;
* ``std::generate_canonical<float, 1>`` — Glorot init
  (cuda_utils.h:35-47 ``init_matrix_glorot``).

Every function here is pinned bit-for-bit against real libstdc++ output
(tests/test_stdrng.py; goldens produced by tools/stdrng_golden.cpp) so a
training run with ``TrainConfig.reference_rng=True`` draws the exact instance
order, Glorot init (models.params.reference_init_params, drawn between the
first epoch reset and the first batch's negatives exactly as the reference
interleaves them — main.cu:499,520), and negative-label stream the CUDA
binary draws for the same seed — the one interop check stronger than
checkpoint-loader parity.  Full-protocol goldens incl. init:
tools/reference_init_golden.cpp + tests/test_reference_rng.py.
"""

from __future__ import annotations

import struct
from typing import List, MutableSequence, Sequence

_M = 2147483647  # minstd modulus 2^31 - 1
_A = 16807  # minstd_rand0 multiplier
_RANGE = _M - 2  # urngrange = max - min = (m-2) - 1 + ... = 2147483645


class MinstdRand0:
    """``std::minstd_rand0``: x' = 16807 * x mod (2^31 - 1).

    min() = 1, max() = 2^31 - 2.  Seeding follows
    ``linear_congruential_engine::seed``: state = seed mod m, or 1 when that
    is 0 (c == 0).
    """

    __slots__ = ("state",)

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        s = seed % _M
        self.state = s if s else 1

    def __call__(self) -> int:
        self.state = (self.state * _A) % _M
        return self.state

    def discard(self, n: int) -> None:
        """Advance by ``n`` draws in O(log n) (LCG jump via modexp) —
        ``std::minstd_rand0::discard`` equivalent, used to skip past draw
        ranges we do not replay (e.g. the reference's Glorot init)."""
        self.state = (self.state * pow(_A, n, _M)) % _M


def uniform_int(g: MinstdRand0, a: int, b: int) -> int:
    """``std::uniform_int_distribution<int>(a, b)(g)`` — libstdc++'s
    downscaling-with-rejection algorithm (bits/uniform_int_dist.h).  Always
    consumes at least one draw, even for a == b (matching libstdc++)."""
    urange = b - a
    if urange > _RANGE:  # upscaling branch: never reached for int32 params
        raise NotImplementedError("urange exceeds the minstd range")
    if urange == _RANGE:  # libstdc++'s equality branch: raw passthrough
        return g() - 1 + a
    uerange = urange + 1
    scaling = _RANGE // uerange
    past = uerange * scaling
    while True:
        ret = g() - 1
        if ret < past:
            return ret // scaling + a


def uniform_ints(g: MinstdRand0, n: int, a: int, b: int) -> List[int]:
    """``n`` consecutive ``uniform_int`` draws (one distribution object per
    call site is equivalent: the distribution is stateless for these
    parameter types)."""
    return [uniform_int(g, a, b) for _ in range(n)]


def std_shuffle(seq: MutableSequence, g: MinstdRand0) -> None:
    """``std::shuffle(seq.begin(), seq.end(), g)`` — libstdc++'s algorithm
    (bits/stl_algo.h), including the paired-swap fast path that packs two
    swap positions into one engine draw when urange^2 <= urngrange."""
    n = len(seq)
    if n <= 1:
        return
    if _RANGE // n >= n:  # i.e. n * n <= urngrange
        i = 1
        if n % 2 == 0:
            j = uniform_int(g, 0, 1)
            seq[i], seq[j] = seq[j], seq[i]
            i += 1
        while i < n:
            swap_range = i + 1
            # __gen_two_uniform_ints(swap_range, swap_range + 1, g)
            x = uniform_int(g, 0, swap_range * (swap_range + 1) - 1)
            p0, p1 = divmod(x, swap_range + 1)
            seq[i], seq[p0] = seq[p0], seq[i]
            i += 1
            seq[i], seq[p1] = seq[p1], seq[i]
            i += 1
        return
    for i in range(1, n):
        j = uniform_int(g, 0, i)
        seq[i], seq[j] = seq[j], seq[i]


def _lcg_block(state: int, n: int) -> "np.ndarray":
    """The next ``n`` raw minstd_rand0 outputs as uint64, vectorized.

    out[i] = state * A^(i+1) mod M, built by index doubling (every value
    < 2^31, so uint64 products never overflow).
    """
    import numpy as np

    p = np.empty(n, np.uint64)
    p[0] = _A
    k = 1
    while k < n:
        m = min(k, n - k)
        # p[k+j] = A^(k+j+1) = p[j] * A^k = p[j] * p[k-1]
        p[k:k + m] = (p[:m] * p[k - 1]) % np.uint64(_M)
        k *= 2
    return (p * np.uint64(state)) % np.uint64(_M)


def past_threshold(uerange: int) -> int:
    """libstdc++'s downscaling acceptance bound: a raw draw with
    ret = g() - 1 is accepted iff ret < past (bits/uniform_int_dist.h)."""
    if uerange - 1 > _RANGE:
        raise NotImplementedError("urange exceeds the minstd range")
    return uerange * (_RANGE // uerange)


def fast_forward_uniform_draws(g: MinstdRand0, pasts) -> None:
    """Advance ``g`` past ``len(pasts)`` uniform_int draws whose acceptance
    thresholds are ``pasts[i]`` — exactly the state the scalar
    ``uniform_int`` loop would leave, without computing the values.

    Vectorized via the dangerous-raw observation: a raw with
    ret < min(pasts) is accepted by EVERY draw, so only the tiny fraction
    of raws with ret >= past_min (< uerange_max / 2^31 of the stream) can
    cause a rejection and needs scalar alignment.  Used by
    ``instances.skip_epochs`` to replay resume streams in numpy instead of
    minutes of pure-Python draw spinning (advisor finding, round 4);
    differential-tested against the scalar twins in tests/test_stdrng.py.
    """
    import numpy as np

    pasts = np.asarray(pasts, np.int64)
    num = int(pasts.shape[0])
    if num == 0:
        return
    past_min = int(pasts.min())
    d = 0
    while d < num:
        n = min(max(int((num - d) * 1.02) + 16, 1024), 1 << 22)
        raws = _lcg_block(g.state, n).astype(np.int64)
        rets = raws - 1
        pos = 0  # raws consumed within this chunk
        finished = False
        for dp in np.flatnonzero(rets >= past_min):
            dp = int(dp)
            take = dp - pos  # safe raws: one accepted draw each
            if d + take >= num:
                pos += num - d
                d = num
                finished = True
                break
            d += take
            # The dangerous raw meets draw d.
            if rets[dp] < pasts[d]:
                d += 1
            # else rejected: draw d retries with the next raw.
            pos = dp + 1
            if d >= num:
                finished = True
                break
        if not finished:
            take = n - pos
            if d + take >= num:
                pos += num - d
                d = num
            else:
                d += take
                pos = n
        if pos > 0:
            g.state = int(raws[pos - 1])


def shuffle_draw_pasts(n: int) -> "np.ndarray":
    """Acceptance thresholds of every engine draw ``std_shuffle`` over
    ``n`` elements consumes, in order (values irrelevant for skipping)."""
    import numpy as np

    if n <= 1:
        return np.zeros(0, np.int64)
    if _RANGE // n >= n:  # paired-swap fast path
        pasts = []
        i = 1
        if n % 2 == 0:
            pasts.append(past_threshold(2))
            i += 1
        while i < n:
            swap_range = i + 1
            pasts.append(past_threshold(swap_range * (swap_range + 1)))
            i += 2
        return np.asarray(pasts, np.int64)
    ue = np.arange(2, n + 1, dtype=np.int64)  # draws uniform(0, i), i=1..n-1
    return ue * (_RANGE // ue)


def generate_canonical_f32(g: MinstdRand0) -> float:
    """``std::generate_canonical<float, 1>(g)``: one engine draw, computed
    in float32 exactly as libstdc++ does (sum and divisor both f32)."""
    raw = float(g() - 1)
    num = struct.unpack("f", struct.pack("f", raw))[0]
    den = struct.unpack("f", struct.pack("f", float(_M - 1)))[0]
    ret = struct.unpack("f", struct.pack("f", num / den))[0]
    # libstdc++ clamps the (rare) ret == 1.0 case to nextafter(1, 0).
    if ret >= 1.0:
        ret = struct.unpack("<f", struct.pack("<I", 0x3F7FFFFF))[0]
    return ret


def glorot_uniform_f32(g: MinstdRand0, rows: int, cols: int) -> "np.ndarray":
    """``init_matrix_glorot`` (cuda_utils.h:35-47) as one float32 array:
    element i = ``2 * max * (generate_canonical<float,1>(g) - 0.5)`` with
    ``const float max = sqrt(6.0 / (rows + cols))``, in the reference's
    FLOATING_POINT_TYPE=float release build.

    Each element takes exactly one engine draw, so the raw draws are one
    ``_lcg_block`` and numpy repeats ``generate_canonical_f32``'s scalar
    arithmetic: the canonical value is a float32 quotient (IEEE division
    rounds it as the double quotient rounded to float32 does).  C++
    promotion semantics matter for bit-exactness: ``0.5`` is a double
    literal, so ``canonical - 0.5`` and the outer product evaluate in
    DOUBLE precision with a single rounding to float at the assignment —
    rounding the difference to f32 first diverges by one ulp for part of
    the c < 0.25 draws (Sterbenz only covers c in [0.25, 1]).  Held to the
    scalar loop of the JAX package's copy, which is pinned against live
    g++, in tests/test_torch_reference_rng.py."""
    import math

    import numpy as np

    n = rows * cols
    if n == 0:
        return np.zeros(0, np.float32)
    raws = _lcg_block(g.state, n)
    g.state = int(raws[-1])
    num = (raws - np.uint64(1)).astype(np.float64).astype(np.float32)
    ret = num / np.float32(float(_M - 1))
    # libstdc++ clamps the (rare) ret == 1.0 case to nextafter(1, 0).
    ret[ret >= np.float32(1.0)] = np.uint32(0x3F7FFFFF).view(np.float32)
    mx = np.float32(math.sqrt(6.0 / (rows + cols)))  # const FloatT max
    two_mx = np.float32(2.0 * float(mx))  # 2 * max: exact
    # float * (float - double) -> double, one final f32 rounding.
    return (float(two_mx) * (ret.astype(np.float64) - 0.5)).astype(np.float32)


def reference_negative_labels(
    g: MinstdRand0, labels: Sequence[int], num_entities: int, k: int
) -> List[List[int]]:
    """The reference's per-batch negative-label stream
    (cpp/labels.cu:3-22): for each instance in batch order, ``k`` draws of
    ``uniform_int(0, num_entities - 1)`` from the shared stream."""
    return [uniform_ints(g, k, 0, num_entities - 1) for _ in labels]
