"""Operations and bytes of the Mix 'n Match composite's work (the text
objective and the entity similarity of pairs), from the shapes.

* A training step's model FLOPs: the text part as ``text_entity`` counts
  it, plus the dots of B pairs of d_e-wide entity rows (2 B d_e) forward
  and twice that backward, 6 B d_e; the pair batch is the text batch's
  size.
* The full_adam sweep over both tables and the bfloat16 copy of the word
  table: ``text_entity``'s counts over this configuration's shapes (65,536
  × 300 + 65,536 × 256 elements; no copy under float32 streams).
"""

from __future__ import annotations

from nvsm_bench.work import text_entity
from nvsm_bench.work.text_entity import cast, sweep, sweep_elements  # noqa: F401


def train_step_flops(config: dict) -> float:
    b, d_e = config["train"]["batch_size"], config["model"]["entity_repr_size"]
    return text_entity.train_step_flops(config) + 6.0 * b * d_e
