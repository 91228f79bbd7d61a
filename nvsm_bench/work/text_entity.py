"""Operations and bytes of the text-entity model's work, from the shapes.

* A training step's model FLOPs: the projection of B phrases (2 B d_w d_e)
  and the scores of B instances against 1 + k documents (2 B (k + 1) d_e),
  forward, and twice that backward: 3 (2 B d_w d_e + 2 B (k + 1) d_e).  The
  count does not depend on the layout (per-instance or pooled negatives).
* The full_adam sweep over both tables: each element read four times
  (gradient, m, v, table) and written three times (m, v, table), 28 bytes,
  and 14 float32 operations (``chip_smoke.py``'s count).
* The bfloat16 copy of the word table: 4 bytes read and 2 written per
  element, one operation; none under float32 streams.
"""

from __future__ import annotations

SWEEP_BYTES, SWEEP_OPS = 28, 14
CAST_BYTES, CAST_OPS = 6, 1


def _sizes(config: dict):
    m, t, c = config["model"], config["train"], config["collection"]
    return (m["word_repr_size"], m["entity_repr_size"], t["batch_size"],
            t["num_random_entities"], c["vocab_size"], c["num_docs"])


def train_step_flops(config: dict) -> float:
    d_w, d_e, b, k, _, _ = _sizes(config)
    return 3.0 * (2.0 * b * d_w * d_e + 2.0 * b * (k + 1) * d_e)


def sweep_elements(config: dict) -> int:
    d_w, d_e, _, _, v, n = _sizes(config)
    return v * d_w + n * d_e


def sweep(config: dict):
    """(bytes, operations) of one step's sweeps over both tables."""
    e = sweep_elements(config)
    return SWEEP_BYTES * e, SWEEP_OPS * e


def cast(config: dict):
    """(bytes, operations) of one step's bfloat16 copy of the word table,
    or None where the streams are float32."""
    if config["train"]["stream_dtype"] != "bfloat16":
        return None
    d_w, _, _, _, v, _ = _sizes(config)
    return CAST_BYTES * v * d_w, CAST_OPS * v * d_w

