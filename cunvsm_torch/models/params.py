"""Model parameters as a NamedTuple of tensors.

Port of ``cunvsm_tpu/models/params.py``, with the same layouts:

* ``word_reprs``:   [num_words,    word_dim]
* ``entity_reprs``: [num_entities, entity_dim]
* ``transform_w``:  [word_dim,     entity_dim]  (projection is x @ W + b)
* ``transform_b``:  [entity_dim]

The training step updates these tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cunvsm_torch.config import ModelDesc


class ModelParams(NamedTuple):
    word_reprs: torch.Tensor
    entity_reprs: torch.Tensor
    transform_w: torch.Tensor
    transform_b: torch.Tensor

    @property
    def num_words(self) -> int:
        return self.word_reprs.shape[0]

    @property
    def num_entities(self) -> int:
        return self.entity_reprs.shape[0]


def glorot_uniform(
    generator: torch.Generator, rows: int, cols: int, dtype, device
) -> torch.Tensor:
    """Uniform on [-sqrt(6/(rows+cols)), +sqrt(6/(rows+cols))], the limits of
    the reference's host init (cuda_utils.h:35-56).  ``generator`` lives on
    ``device``."""
    limit = (6.0 / (rows + cols)) ** 0.5
    out = torch.empty((rows, cols), dtype=dtype, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def init_params(
    generator: torch.Generator,
    num_words: int,
    num_entities: int,
    desc: ModelDesc,
    dtype=torch.float32,
    device=None,
) -> ModelParams:
    """Glorot-init representations and transform; zero bias
    (params.cu:361-372).  Draws words, entities, then the transform from
    ``generator``, which must live on ``device``."""
    d_w, d_e = desc.word_repr_size, desc.entity_repr_size
    return ModelParams(
        word_reprs=glorot_uniform(generator, num_words, d_w, dtype, device),
        entity_reprs=glorot_uniform(generator, num_entities, d_e, dtype, device),
        transform_w=glorot_uniform(generator, d_w, d_e, dtype, device),
        transform_b=torch.zeros((d_e,), dtype=dtype, device=device),
    )


def tensor_from_numpy(x, device=None, dtype=None) -> torch.Tensor:
    """A fresh tensor holding a copy of the array ``x``."""
    t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(params, device=None, dtype=None) -> ModelParams:
    """ModelParams from any object with the four fields as arrays, such as
    the JAX package's ModelParams."""
    return ModelParams(
        *(
            tensor_from_numpy(getattr(params, f), device, dtype)
            for f in ModelParams._fields
        )
    )


def params_to_numpy(params: ModelParams) -> ModelParams:
    """The same NamedTuple holding numpy arrays (host copies: of a CPU
    tensor too, which the in-place steps would otherwise change)."""
    return ModelParams(*(t.detach().cpu().numpy().copy() for t in params))
