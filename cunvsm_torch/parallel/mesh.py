"""Multi-device sharding: a 2-D mesh of processes, one device each.

Port of ``cunvsm_tpu/parallel/mesh.py``.  The layout is the JAX package's:

* a mesh with the axes ``("data", "model")``; rank ``r`` sits at data index
  ``r // model`` and model index ``r % model``;
* the **entity table is the only tensor that outgrows one device**: it, and
  every optimizer leaf whose leading dimension is the entity count (m, v,
  Adagrad accumulators, the [N] v of sparse and dense-update Adam), is
  sharded by rows over the model axis (rank m holds the contiguous rows
  [m*R, (m+1)*R), R = padded N / model) and replicated over the data axis;
* the word table, the transform and their optimizer state are replicated;
* batch rows are split over the data axis; the ranks of one data group
  compute the same forward pass.

Where the JAX package annotates shardings and lets GSPMD insert the
collectives, this package writes the SPMD program out: ``train/step.py``,
``models/objectives.py`` and ``optim/updates.py`` take a :class:`Mesh` and
call its collectives, which ``parallel/distributed.py`` counts by name.  A
mesh made in a process that joined no group is 1x1 and calls none.

The sharded direction of the state: :func:`shard_params` /
:func:`shard_opt_state` cut a rank's rows from full tensors (padding the
entity rows with zeros up to a multiple of the model axis), and
:func:`fetch_params` / :func:`fetch_opt_state` put them together again on
every rank (collectives).  Padded rows are never drawn as negatives, stay
zero, and are cut off before a model file is written.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from cunvsm_torch.config import ModelDesc, TrainConfig
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.optim.updates import OptState
from cunvsm_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
WORLD = None  # the axis name of "every rank"


class Mesh:
    """A ``data`` x ``model`` grid over the ranks of the process group.

    ``shape`` maps axis names to sizes, as ``jax.sharding.Mesh.shape``
    does.  The collectives take an axis name (``"data"``: the ranks that
    hold the same entity rows; ``"model"``: the ranks that hold the same
    batch rows; ``None``: every rank) and the name under which
    ``distributed.collective_log`` counts the call.
    """

    def __init__(self, data: int, model: int, rank: int = 0, groups=None):
        self.data, self.model = int(data), int(model)
        self.shape = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, self.model)
        self._groups = groups

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return f"Mesh({self.data}x{self.model}, rank {self.rank})"

    def all_reduce(self, tensor, axis, name: str):
        if self._groups is None:
            return tensor
        return distributed.all_reduce(tensor, name, self._groups[axis])

    def all_reduce_grad(self, tensor, axis, name: str):
        if self._groups is None:
            return tensor
        return distributed.all_reduce_grad(tensor, name, self._groups[axis])

    def all_gather(self, tensor, axis, name: str, dim: int = 0):
        if self._groups is None:
            return tensor
        return distributed.all_gather(tensor, name, self._groups[axis], dim=dim)

    def batch_rows(self, num_rows: int) -> slice:
        """This rank's rows of a global batch: split over the data axis."""
        if num_rows % self.data:
            raise ValueError(
                f"batch_size {num_rows} not divisible by data axis {self.data}"
            )
        n = num_rows // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def entity_rows(self, padded_rows: int) -> slice:
        """This rank's rows of the padded entity table."""
        n = padded_rows // self.model
        return slice(self.model_index * n, (self.model_index + 1) * n)

    def gather_rows(self, shard: torch.Tensor, ids: torch.Tensor, name: str,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """[len(ids), d] rows ``ids`` (global rows, the same on every rank of
        the model axis) of a table of which ``shard`` holds this rank's
        rows, cast to ``dtype`` when given.  Each rank selects the rows it
        owns, zeros elsewhere, and one all-reduce over the model axis
        completes them; adding zeros is exact, so the rows are bitwise the
        owner's.  The traffic is that of the gathered rows, never of the
        table."""
        shard_rows = shard.shape[0]
        local = ids - self.model_index * shard_rows
        owned = (local >= 0) & (local < shard_rows)
        rows = shard.index_select(0, local.clamp(0, shard_rows - 1))
        if dtype is not None:
            rows = rows.to(dtype)
        rows = torch.where(
            owned[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)
        )
        return self.all_reduce(rows, MODEL_AXIS, name)


def make_mesh(data: int, model: int) -> Mesh:
    """A ``data`` x ``model`` mesh over the ranks of the process group that
    ``distributed.initialize`` joined.  Every rank must call it, at the same
    point: it makes one process group per mesh row and per column, in the
    same order everywhere.  Without a process group only 1x1 exists."""
    world = distributed.process_count()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} processes; the "
            f"process group has {world}"
        )
    if not distributed.is_initialized():
        return Mesh(1, 1)
    rank = dist.get_rank()
    groups = {WORLD: dist.group.WORLD}
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == rank // model:
            groups[MODEL_AXIS] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == rank % model:
            groups[DATA_AXIS] = g
    return Mesh(data, model, rank, groups)


def parse_mesh_shape(text: str) -> Tuple[int, int]:
    """(data, model) of a ``'DATAxMODEL'`` flag value."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes 'DATAxMODEL' (e.g. 2x2), not {text!r}") from None
    return data, model


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split devices between the data and model axes: prefer sharding the
    entity table over the model axis, with data parallelism on top."""
    if n_devices <= 1:
        return (1, 1)
    if n_devices % 2:
        return (1, n_devices)
    return (2, n_devices // 2)


def pad_entities(n: int, model_axis: int) -> int:
    """Entity-table rows padded up to a multiple of the model axis."""
    return ((n + model_axis - 1) // model_axis) * model_axis


def shard_rows(mesh: Mesh, full: torch.Tensor, padded: int) -> torch.Tensor:
    """This rank's rows of ``full`` zero-padded to ``padded`` rows (a copy)."""
    if full.shape[0] > padded:
        raise ValueError(f"{full.shape[0]} rows do not fit {padded} padded rows")
    rows = mesh.entity_rows(padded)
    out = full.new_zeros((rows.stop - rows.start, *full.shape[1:]))
    have = full[rows.start:min(rows.stop, full.shape[0])]
    out[: have.shape[0]] = have
    return out


def shard_params(mesh: Mesh, params: ModelParams) -> ModelParams:
    """This rank's part of full ``params`` (with N or padded-N entity
    rows): the entity rows of its model index, the rest as it is."""
    padded = pad_entities(params.num_entities, mesh.model)
    return params._replace(entity_reprs=shard_rows(mesh, params.entity_reprs, padded))


def shard_opt_state(mesh: Mesh, opt_state: OptState, num_entities: int) -> OptState:
    """This rank's part of a full optimizer state: the entity leaves whose
    leading dimension is ``num_entities`` (the row count of the table the
    state was made for) cut like the entity table, the rest as it is."""
    padded = pad_entities(num_entities, mesh.model)

    def leaf(t):
        if t.ndim >= 1 and t.shape[0] == num_entities:
            return shard_rows(mesh, t, padded)
        return t

    return opt_state._replace(entity=type(opt_state.entity)(*map(leaf, opt_state.entity)))


def fetch_params(mesh: Mesh, params: ModelParams, num_entities: Optional[int] = None) -> ModelParams:
    """Full parameters from the ranks' shards, on every rank (a
    collective); ``num_entities`` cuts the padded rows off."""
    entity = mesh.all_gather(params.entity_reprs, MODEL_AXIS, "fetch")
    if num_entities is not None:
        entity = entity[:num_entities]
    return params._replace(entity_reprs=entity)


def fetch_opt_state(mesh: Mesh, opt_state: OptState) -> OptState:
    """The full (padded) optimizer state on every rank (a collective)."""

    def leaf(t):
        return mesh.all_gather(t, MODEL_AXIS, "fetch") if t.ndim >= 1 else t

    return opt_state._replace(entity=type(opt_state.entity)(*map(leaf, opt_state.entity)))


def local_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: every tensor field sliced over
    the data axis; a composite's (text, similarity) pair field by field."""
    if isinstance(batch, tuple) and not hasattr(batch, "_fields"):
        return tuple(local_batch(mesh, b) for b in batch)
    return type(batch)(*(
        None if leaf is None else leaf[mesh.batch_rows(leaf.shape[0])] for leaf in batch
    ))


def local_negative_ids(mesh: Mesh, negative_ids):
    """Per-instance [B, k] negatives sliced like the batch; a [P] pool or
    [k] shared ids are the same on every rank."""
    if negative_ids is None or negative_ids.ndim != 2:
        return negative_ids
    return negative_ids[mesh.batch_rows(negative_ids.shape[0])]


def make_sharded_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    mesh: Mesh,
    params: ModelParams,
    opt_state: OptState,
    device,
    generator: torch.Generator,
    kind=None,
    num_entities: Optional[int] = None,
):
    """The host-fed train step over ``mesh``.

    Returns ``(step, sharded_params, sharded_opt_state)``: ``params`` and
    ``opt_state`` are full tensors, the same on every rank, and are cut to
    this rank's shards.  ``step(params, opt_state, batch, negative_ids=None)``
    takes the *global* batch (the same on every rank), keeps this rank's
    rows, updates the shards in place and returns the global cost, on every
    rank.  ``num_entities`` is the real entity count when ``params`` is
    already padded.
    """
    from cunvsm_torch.train.step import make_train_step

    num_entities = num_entities or params.num_entities
    inner = make_train_step(
        desc, cfg, device, generator, num_entities=num_entities, kind=kind, mesh=mesh
    )

    def step(p, o, batch, negative_ids=None):
        return inner(
            p, o, local_batch(mesh, batch),
            negative_ids=local_negative_ids(mesh, negative_ids),
        )

    return (
        step,
        shard_params(mesh, params),
        shard_opt_state(mesh, opt_state, params.num_entities),
    )


def make_sharded_multistep(
    desc: ModelDesc,
    cfg: TrainConfig,
    mesh: Mesh,
    params: ModelParams,
    opt_state: OptState,
    device,
    generator: torch.Generator,
    num_steps: int,
    kind=None,
    num_entities: Optional[int] = None,
):
    """K = ``num_steps`` chained sharded steps per call over stacked
    [K, B, ...] global batches.  Returns ``(run, sharded_params,
    sharded_opt_state)``; ``run(params, opt_state, stacked, negative_ids=None)``
    returns the K global costs as one [K] tensor (``negative_ids``: K of
    them, or None to draw)."""
    step, sharded_params, sharded_state = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, device, generator, kind, num_entities
    )

    def unstack(stacked, i):
        if isinstance(stacked, tuple) and not hasattr(stacked, "_fields"):
            return tuple(unstack(s, i) for s in stacked)
        return type(stacked)(*(None if leaf is None else leaf[i] for leaf in stacked))

    def run(p, o, stacked, negative_ids=None):
        if negative_ids is not None and len(negative_ids) != num_steps:
            raise ValueError(f"{len(negative_ids)} draws for {num_steps} steps")
        costs = [
            step(p, o, unstack(stacked, i),
                 None if negative_ids is None else negative_ids[i])
            for i in range(num_steps)
        ]
        return torch.stack(costs)

    return run, sharded_params, sharded_state
