"""HDF5 checkpoints in the reference's layout, the ``_meta`` sidecar, and
resume, without h5py or protobuf.

Port of ``cunvsm_tpu/io/checkpoint.py`` for the PyTorch package.  The
machine this package targets has neither h5py nor protobuf, so the files
are written by hand:

* ``<prefix>_<epoch>.hdf5``: four little-endian float32 datasets in the
  root group, the reference's names and shapes (``io/hdf5.py``).  The JAX
  package lets h5py chunk tables of 8192 rows or more into blocks of 2048
  rows; this package writes every table contiguous.  h5py, the
  reference's ``py/nvsm`` and this package's reader read both.
* ``<prefix>_meta``: the ``lse.Metadata`` message
  (``cunvsm_tpu/proto/nvsm.proto``, proto3, every field int32) with a
  wire encoder and decoder of its own.  The bytes equal
  ``SerializeToString()`` of the protobuf runtime: fields in field-number
  order, a scalar equal to 0 left out (proto3 has no presence), every
  repeated element written even when empty, a negative int32 as a 10-byte
  varint.
* ``<prefix>_resume.npz``: the parameters, the optimizer state (its step
  counters included) and the epoch, in the JAX package's key names.  No
  random-generator state is saved: the trainer reseeds every generator
  from the seed and a counter (``train/trainer.py``), and the counter is
  ``extra_total_batches``.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cunvsm_torch.io import hdf5
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.optim.updates import OptState

WORD_REPRS = "word_representations-representations"
ENTITY_REPRS = "entity_representations-representations"
TRANSFORM = "word_entity_mapping-transform"
BIAS = "word_entity_mapping-bias"


def checkpoint_path(prefix: str, epoch) -> str:
    return f"{prefix}_{epoch}.hdf5"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_model_hdf5(params: ModelParams, prefix: str, epoch, overwrite: bool = False) -> str:
    """Write the four tables as float32; refuse to overwrite unless
    ``overwrite`` (H5F_ACC_EXCL, lse_hdf5_inl.h:25).  The file is written
    to ``<path>.tmp`` and renamed, so a crash never leaves a truncated file
    at the contract path."""
    path = checkpoint_path(prefix, epoch)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    tables = {
        WORD_REPRS: _host(params.word_reprs),
        ENTITY_REPRS: _host(params.entity_reprs),
        TRANSFORM: _host(params.transform_w),
        BIAS: _host(params.transform_b).reshape(1, -1),
    }
    tmp_path = path + ".tmp"
    with open(tmp_path, "wb") as f:
        hdf5.write_datasets(f, {k: v.astype(np.float32, copy=False) for k, v in tables.items()})
    os.replace(tmp_path, path)
    return path


def load_model_hdf5(prefix: str, epoch, device, dtype=None) -> ModelParams:
    """The tables of ``<prefix>_<epoch>.hdf5`` as tensors on ``device``.
    Reads the files ``save_model_hdf5`` writes and the contiguous and
    chunked files that h5py writes (every file of the JAX package's
    writer); a filtered file raises ``ValueError``."""
    with open(checkpoint_path(prefix, epoch), "rb") as f:
        data = hdf5.read_datasets(f)

    def put(name):
        return torch.from_numpy(data[name]).to(device=device, dtype=dtype)

    return ModelParams(
        word_reprs=put(WORD_REPRS),
        entity_reprs=put(ENTITY_REPRS),
        transform_w=put(TRANSFORM),
        transform_b=put(BIAS).reshape(-1),
    )


# ---------------------------------------------------------------------------
# The lse.Metadata message.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TermInfo:  # fields 1, 2, 3
    index_term_id: int = 0
    model_term_id: int = 0
    term_frequency: int = 0


@dataclasses.dataclass
class ObjectInfo:  # fields 1, 2
    index_object_id: int = 0
    model_object_id: int = 0


@dataclasses.dataclass
class Metadata:
    term: List[TermInfo] = dataclasses.field(default_factory=list)  # field 1
    object: List[ObjectInfo] = dataclasses.field(default_factory=list)  # field 2
    total_terms: int = 0  # field 3

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for number, infos in ((1, self.term), (2, self.object)):
            for info in infos:
                body = _int_fields(dataclasses.astuple(info))
                out += _varint((number << 3) | 2) + _varint(len(body)) + body
        return bytes(out + _int_fields((0, 0, self.total_terms)))

    @classmethod
    def FromString(cls, data: bytes) -> "Metadata":
        meta = cls()
        for number, value in _fields(data):
            if number == 1:
                meta.term.append(TermInfo(*_parse_ints(value, 3)))
            elif number == 2:
                meta.object.append(ObjectInfo(*_parse_ints(value, 2)))
            elif number == 3:
                meta.total_terms = _int32(value)
        return meta


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # a negative int32 is sign-extended to 64 bits
    out = bytearray()
    while value > 0x7F:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def _int_fields(values) -> bytes:
    """int32 fields numbered 1, 2, ... in order, each left out when 0."""
    return b"".join(
        _varint(number << 3) + _varint(int(v))
        for number, v in enumerate(values, start=1) if v
    )


def _int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _fields(data: bytes):
    """(field number, value) pairs: an int for varints, bytes for
    length-delimited fields; fixed-width fields are skipped."""
    pos = 0

    def varint():
        nonlocal pos
        shift = result = 0
        while True:
            if pos >= len(data):
                raise ValueError("truncated protobuf varint")
            b = data[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    while pos < len(data):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            yield number, varint()
        elif wire == 2:
            n = varint()
            yield number, data[pos:pos + n]
            pos += n
        elif wire in (1, 5):
            pos += 8 if wire == 1 else 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def _parse_ints(data: bytes, count: int) -> List[int]:
    values = [0] * count
    for number, value in _fields(data):
        if 1 <= number <= count and isinstance(value, int):
            values[number - 1] = _int32(value)
    return values


def build_metadata(
    index_term_ids: Sequence[int],
    term_frequencies: Sequence[int],
    num_objects: int,
    total_terms: int,
    include_oov: bool,
    index_object_ids: Optional[Sequence[int]] = None,
) -> Metadata:
    """The lse.Metadata of a model (data_indri.cpp:534-555): one TermInfo
    per model term, one ObjectInfo per model object; without external
    object ids, index_object_id == model_object_id."""
    meta = Metadata(total_terms=int(total_terms))
    for model_id, (iid, freq) in enumerate(zip(index_term_ids, term_frequencies)):
        if include_oov and model_id == 0:
            # The OOV slot keeps index id 0 / frequency 1
            # (data_indri.cpp:812-822).
            iid, freq = 0, 1
        meta.term.append(TermInfo(int(iid), int(model_id), int(freq)))
    for model_id in range(num_objects):
        iid = index_object_ids[model_id] if index_object_ids is not None else model_id
        meta.object.append(ObjectInfo(int(iid), int(model_id)))
    return meta


def save_meta(meta: Metadata, prefix: str) -> str:
    path = f"{prefix}_meta"
    with open(path, "wb") as f:
        f.write(meta.SerializeToString())
    return path


def load_meta(prefix: str) -> Metadata:
    with open(f"{prefix}_meta", "rb") as f:
        return Metadata.FromString(f.read())


def save_strings(strings: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        for s in strings:
            f.write(s + "\n")


def load_strings(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def save_corpus_sidecars(corpus, prefix: str) -> None:
    """Vocabulary terms and docnos in model-id order, and the indexing-time
    stemmer when the corpus has one."""
    save_strings(corpus.vocab.terms, f"{prefix}_vocab.txt")
    save_strings(corpus.docnos, f"{prefix}_docnos.txt")
    if getattr(corpus, "stemmer", None):
        save_strings([corpus.stemmer], f"{prefix}_stemmer.txt")


# ---------------------------------------------------------------------------
# Training-state resume.
# ---------------------------------------------------------------------------


def state_leaves(params: ModelParams, opt_state: OptState) -> List[torch.Tensor]:
    """The leaves of (params, opt_state) in the order of the JAX package's
    ``tree_flatten``: the four tables, then per table (m, v, t) for the
    words and the entities and (m_w, m_b, v_w, v_b, t) for the transform."""
    return [*params, *(t for s in opt_state for t in s)]


def save_training_state(
    prefix: str,
    params: ModelParams,
    opt_state: OptState,
    epoch: int,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """``<prefix>_resume.npz``: ``__epoch__``, ``leaf_<i>`` and
    ``extra_<key>``; written to a temporary name and renamed."""
    path = f"{prefix}_resume.npz"
    arrays: Dict[str, np.ndarray] = {"__epoch__": np.asarray(epoch)}
    for i, leaf in enumerate(state_leaves(params, opt_state)):
        arrays[f"leaf_{i}"] = _host(leaf)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_training_state(prefix: str, params: ModelParams, opt_state: OptState,
                        shard_rows=None):
    """Copy the saved state into ``params`` and ``opt_state`` in place
    (each leaf keeps its dtype and device); returns (params, opt_state,
    epoch, extra).  ``shard_rows = (full_rows, rows)`` loads a mesh rank's
    shards from the full padded layout: a saved leaf with ``full_rows``
    rows whose model leaf has the ``rows`` slice's length is cut to
    ``rows``."""
    with np.load(f"{prefix}_resume.npz") as data:
        leaves = state_leaves(params, opt_state)
        saved = [k for k in data.files if k.startswith("leaf_")]
        if len(saved) != len(leaves):
            raise ValueError(
                f"resume file holds {len(saved)} leaves, the model {len(leaves)}"
            )
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if (
                shard_rows is not None and arr.ndim and leaf.ndim
                and arr.shape[0] == shard_rows[0] != leaf.shape[0]
                and leaf.shape[0] == shard_rows[1].stop - shard_rows[1].start
            ):
                arr = arr[shard_rows[1]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"resume leaf {i}: shape {arr.shape}, expected {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(arr))
        epoch = int(data["__epoch__"])
        extra = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}
    return params, opt_state, epoch, extra


class AsyncCheckpointWriter:
    """Epoch-boundary checkpoint IO off the training thread.

    The training thread pays only a device-side ``clone()`` of every tensor,
    taken on the current stream: the step updates the tables in place, so
    the clone is what keeps the snapshot from moving under the next step
    (the JAX package's ``jnp.copy`` against buffer donation).  One worker
    thread then copies each snapshot to the host and writes the files, in
    submission order.  For CUDA tensors it does so on a stream of its own
    that first waits on an event recorded after the clones: the copy to the
    host is ordered after the clone, and not after the steps enqueued since.
    The queue is bounded (``max_pending`` jobs); the worker's first error is
    kept and raised by the next ``save_*``, ``wait`` or ``close``, after
    which the writer stays usable."""

    def __init__(self, max_pending: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._stream = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                fn, args, kwargs, ready = job
                if ready is None:
                    fn(*args, **kwargs)
                    continue
                if self._stream is None:
                    self._stream = torch.cuda.Stream()
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(ready)
                    fn(*args, **kwargs)
            except BaseException as exc:  # raised to the caller later
                if self._error is None:
                    self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    @classmethod
    def _clone(cls, tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        return type(tree)(*(cls._clone(t) for t in tree))

    def _submit(self, fn, args, kwargs, device):
        self._raise_pending()
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._queue.put((fn, args, kwargs, ready))

    def save_model(self, params: ModelParams, prefix: str, epoch, overwrite: bool = False):
        self._submit(save_model_hdf5, (self._clone(params), prefix, epoch),
                     dict(overwrite=overwrite), params.word_reprs.device)

    def save_training_state(self, prefix: str, params, opt_state, epoch, extra=None):
        snap = (self._clone(params), self._clone(opt_state))
        self._submit(save_training_state, (prefix, *snap, epoch), dict(extra=extra),
                     params.word_reprs.device)

    def wait(self):
        """Block until every submitted write has finished; raise the first
        error of the worker, if any."""
        self._queue.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            self._queue.put(None)
            self._thread.join()
