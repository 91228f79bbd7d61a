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
from cunvsm_torch.data.stdrng import MinstdRand0, glorot_uniform_f32


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
    *,
    device,
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


def reference_init_params(
    engine: MinstdRand0,
    num_words: int,
    num_entities: int,
    desc: ModelDesc,
    dtype=torch.float32,
    *,
    device,
) -> ModelParams:
    """Bit-exact twin of the reference's host Glorot init, drawn from the
    shared minstd_rand0 ``engine`` (``data/stdrng.py``), as
    ``cunvsm_tpu.models.params.reference_init_params`` draws it.

    Draw order follows ModelBase::initialize (model.cu:37-43): words, then
    entities, then the transform; the bias is zero and consumes no draws
    (params.cu:361-372).  Each matrix is filled in device_matrix
    column-major order (cuda_utils.h:44-47) with the limit
    sqrt(6 / (rows + cols)) of the device shape, (repr_size, num_objects)
    for representations and (entity_dim, word_dim) for the transform, which
    is a plain reshape of the draw stream into this package's layouts.  The
    values are computed on the host in float32 as in the reference's
    release build, then copied to ``device`` in ``dtype``."""
    d_w, d_e = desc.word_repr_size, desc.entity_repr_size
    words = glorot_uniform_f32(engine, d_w, num_words).reshape(num_words, d_w)
    entities = glorot_uniform_f32(engine, d_e, num_entities).reshape(num_entities, d_e)
    transform = glorot_uniform_f32(engine, d_e, d_w).reshape(d_w, d_e)
    return ModelParams(
        word_reprs=tensor_from_numpy(words, device, dtype),
        entity_reprs=tensor_from_numpy(entities, device, dtype),
        transform_w=tensor_from_numpy(transform, device, dtype),
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
