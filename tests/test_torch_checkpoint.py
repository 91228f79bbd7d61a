"""The port's checkpoint files against h5py, protobuf and the JAX writer.

* ``<prefix>_<epoch>.hdf5``: h5py reads the port's file (names, shapes,
  ``<f4``, values bit for bit, contiguous storage); the port reads every
  file the JAX package writes, bit for bit: the small contiguous ones and
  the tables of 8192 rows or more that h5py chunks into 2048-row blocks
  (one B-tree level, two levels past 64 chunks, a padded edge chunk), and
  rejects filtered files and later superblocks;
* ``<prefix>_meta``: the port's bytes equal ``SerializeToString()`` of the
  JAX package's ``build_metadata`` (OOV slot, negative and zero ids
  included), and each side parses the other's;
* ``<prefix>_resume.npz``: the JAX loader reads the port's file into its own
  trees, and the port the JAX writer's, for every optimizer (SGD has no
  state leaves; Adagrad's accumulators and sparse Adam's [N] variance are
  in the JAX flatten order); the port restores its tensors in place;
* ``AsyncCheckpointWriter``: the error and order contract of
  tests/test_checkpoint.py, and the snapshot taken at submission.
"""

import os
import threading

import numpy as np
import pytest
import torch

from cunvsm_torch.config import ModelDesc
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.io import hdf5
from cunvsm_torch.models.params import ModelParams, init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.config import UPDATE_METHOD_NAMES
from tests.torch_parity import optimizer_config, train_config, twin

h5py = pytest.importorskip("h5py")
jckpt = pytest.importorskip("cunvsm_tpu.io.checkpoint")  # needs protobuf too

from cunvsm_tpu.models.params import ModelParams as JModelParams  # noqa: E402
from cunvsm_tpu.optim.updates import Optimizer as JOptimizer  # noqa: E402

CPU = torch.device("cpu")
NAMES = (tckpt.WORD_REPRS, tckpt.ENTITY_REPRS, tckpt.TRANSFORM, tckpt.BIAS)


def make_params(rows=11, entities=9, d_w=7, d_e=5, seed=0, dtype=torch.float32):
    desc = ModelDesc(word_repr_size=d_w, entity_repr_size=d_e)
    p = init_params(torch.Generator().manual_seed(seed), rows, entities, desc, dtype=dtype,
                    device=CPU)
    return p._replace(transform_b=torch.linspace(-1, 1, d_e, dtype=dtype))


def as_numpy(params):
    return [t.numpy() for t in params]


@pytest.mark.parametrize("rows,dtype", [(11, torch.float32), (8192, torch.float32), (13, torch.float64)])
def test_h5py_reads_the_port_file(tmp_path, rows, dtype):
    params = make_params(rows=rows, dtype=dtype)
    path = tckpt.save_model_hdf5(params, str(tmp_path / "m"), 3)
    assert path.endswith("m_3.hdf5") and not os.path.exists(path + ".tmp")
    want = [a.astype(np.float32) for a in as_numpy(params)]
    want[3] = want[3].reshape(1, -1)
    with h5py.File(path, "r") as f:
        assert set(f.keys()) == set(NAMES)
        for name, w in zip(NAMES, want):
            ds = f[name]
            assert ds.dtype == np.dtype("<f4") and ds.shape == w.shape
            assert ds.chunks is None  # contiguous, also at >= 8192 rows
            np.testing.assert_array_equal(ds[()], w)
    assert os.path.getsize(path) < sum(w.nbytes for w in want) + 4096


def test_port_reads_its_own_file_bitwise(tmp_path):
    params = make_params(seed=1)
    tckpt.save_model_hdf5(params, str(tmp_path / "m"), 1)
    loaded = tckpt.load_model_hdf5(str(tmp_path / "m"), 1, CPU)
    for a, b in zip(params, loaded):
        assert b.dtype == torch.float32
        assert torch.equal(a, b)
    loaded64 = tckpt.load_model_hdf5(str(tmp_path / "m"), 1, CPU, dtype=torch.float64)
    assert loaded64.word_reprs.dtype == torch.float64
    assert loaded64.transform_b.shape == (5,)


def test_port_reads_jax_written_files(tmp_path):
    """JAX's small tables are contiguous h5py datasets."""
    np_params = as_numpy(make_params(seed=2))
    prefix = str(tmp_path / "jax")
    jckpt.save_model_hdf5(JModelParams(*np_params), prefix, 4)
    loaded = tckpt.load_model_hdf5(prefix, 4, CPU)
    for a, b in zip(np_params, loaded):
        np.testing.assert_array_equal(b.numpy(), a)


def _chunked_jax_file(tmp_path, word_rows, entity_rows, seed=0):
    rng = np.random.RandomState(seed)
    params = JModelParams(
        rng.randn(word_rows, 4).astype(np.float32), rng.randn(entity_rows, 3).astype(np.float32),
        rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32),
    )
    prefix = str(tmp_path / f"big{word_rows}")
    jckpt.save_model_hdf5(params, prefix, 1)  # chunked by the JAX writer
    return params, prefix


def _chunk_btree_levels(path, name):
    """Levels of the chunk B-tree of dataset ``name``: its root's level + 1."""
    with open(path, "rb") as f:
        r = hdf5._Reader(f)
        root = r.messages(int.from_bytes(r.read(64, 8), "little"))
        btree, heap = np.frombuffer(root[hdf5.MSG_SYMBOL_TABLE][1][:16], "<u8")
        layout = r.messages(r.group_entries(int(btree), int(heap))[name])[hdf5.MSG_LAYOUT][1]
        assert layout[:2] == b"\x03\x02"
        return r.read(int.from_bytes(layout[3:11], "little"), 8)[5] + 1


def test_port_rejects_chunked_and_filtered_files(tmp_path):
    """A chunked file of the JAX writer is read bitwise; filtered files and
    later superblocks are still refused."""
    big, prefix = _chunked_jax_file(tmp_path, 8192, 9)
    with h5py.File(tckpt.checkpoint_path(prefix, 1), "r") as f:
        assert f[tckpt.WORD_REPRS].chunks == (2048, 4)
    for a, b in zip(big, tckpt.load_model_hdf5(prefix, 1, CPU)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy().view(np.uint32), a.view(np.uint32))
    with h5py.File(tmp_path / "z_1.hdf5", "w") as f:
        for name in NAMES:
            f.create_dataset(name, data=np.ones((4, 3), np.float32), compression="gzip")
    with pytest.raises(ValueError, match="filtered"):
        tckpt.load_model_hdf5(str(tmp_path / "z"), 1, CPU)
    with h5py.File(tmp_path / "l_1.hdf5", "w", libver="latest") as f:
        f.create_dataset(tckpt.BIAS, data=np.ones((1, 3), np.float32))
    with pytest.raises(ValueError, match="superblock version"):
        tckpt.load_model_hdf5(str(tmp_path / "l"), 1, CPU)


@pytest.mark.parametrize("word_rows,entity_rows,levels", [
    (8192, 8193, 1),  # four chunks, and five with a padded edge chunk
    (286720, 10001, 2),  # 140 chunks: more than one node of 64 holds
    (131073, 12345, 2),  # 65 chunks, the last one row
])
def test_port_reads_chunked_jax_files(tmp_path, word_rows, entity_rows, levels):
    want, prefix = _chunked_jax_file(tmp_path, word_rows, entity_rows, seed=word_rows)
    path = tckpt.checkpoint_path(prefix, 1)
    assert _chunk_btree_levels(path, tckpt.WORD_REPRS) == levels
    got = tckpt.load_model_hdf5(prefix, 1, CPU)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), a.view(np.uint32))
    with h5py.File(path, "r") as f:
        for name, b in zip(NAMES, got):
            np.testing.assert_array_equal(f[name][()].reshape(b.shape), b.numpy())


def test_overwrite_guard(tmp_path):
    prefix = str(tmp_path / "m")
    tckpt.save_model_hdf5(make_params(seed=3), prefix, 1)
    with pytest.raises(FileExistsError):
        tckpt.save_model_hdf5(make_params(seed=4), prefix, 1)
    tckpt.save_model_hdf5(make_params(seed=4), prefix, 1, overwrite=True)
    assert torch.equal(tckpt.load_model_hdf5(prefix, 1, CPU).word_reprs, make_params(seed=4).word_reprs)
    assert sorted(os.listdir(tmp_path)) == ["m_1.hdf5"]


def test_write_datasets_rejects_what_it_cannot_write(tmp_path):
    with open(tmp_path / "x", "wb") as f:
        for bad in (np.arange(3), np.ones(3)):
            with pytest.raises(ValueError, match="not float32"):
                hdf5.write_datasets(f, {"a": bad})
        with pytest.raises(ValueError, match="datasets"):
            hdf5.write_datasets(f, {})


@pytest.mark.parametrize("dtype", ["<f8", ">f4", "<i4"])
def test_reader_rejects_other_datatypes(tmp_path, dtype):
    with h5py.File(tmp_path / "x_1.hdf5", "w") as f:
        for name in NAMES:
            f.create_dataset(name, data=np.ones((2, 3), dtype))
    with pytest.raises(ValueError, match="not little-endian float32"):
        tckpt.load_model_hdf5(str(tmp_path / "x"), 1, CPU)


META_CASES = {
    "plain": dict(index_term_ids=[4, 2, 9], term_frequencies=[10, 20, 30], num_objects=2,
                  total_terms=60, include_oov=False),
    "oov_slot": dict(index_term_ids=[0, 7, 3], term_frequencies=[1, 5, 2], num_objects=3,
                     total_terms=7, include_oov=True),
    "negative_and_zero": dict(index_term_ids=[-1, 0, 2**31 - 1, -2**31], term_frequencies=[0, -5, 1, 0],
                              num_objects=2, total_terms=0, include_oov=False,
                              index_object_ids=[-7, 0]),
    "object_ids": dict(index_term_ids=[5], term_frequencies=[300], num_objects=4,
                       total_terms=300, include_oov=False, index_object_ids=[100, 2, 3, 70000]),
    "empty": dict(index_term_ids=[], term_frequencies=[], num_objects=0, total_terms=12,
                  include_oov=False),
}


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_meta_bytes_equal_protobuf(tmp_path, case):
    kw = META_CASES[case]
    jmeta = jckpt.build_metadata(**kw)
    tmeta = tckpt.build_metadata(**kw)
    want = jmeta.SerializeToString()
    assert tmeta.SerializeToString() == want
    tckpt.save_meta(tmeta, str(tmp_path / "t"))
    with open(tmp_path / "t_meta", "rb") as f:
        assert f.read() == want
    # Each side parses the other's file.
    jckpt.save_meta(jmeta, str(tmp_path / "j"))
    assert tckpt.load_meta(str(tmp_path / "j")) == tmeta
    parsed = jckpt.load_meta(str(tmp_path / "t"))
    assert [(t.index_term_id, t.model_term_id, t.term_frequency) for t in parsed.term] == [
        (t.index_term_id, t.model_term_id, t.term_frequency) for t in tmeta.term]
    assert [(o.index_object_id, o.model_object_id) for o in parsed.object] == [
        (o.index_object_id, o.model_object_id) for o in tmeta.object]
    assert parsed.total_terms == tmeta.total_terms


def test_meta_oov_slot_and_negative_varint():
    meta = tckpt.build_metadata([9, 7], [4, 5], 1, 5, include_oov=True)
    assert (meta.term[0].index_term_id, meta.term[0].term_frequency) == (0, 1)
    neg = tckpt.Metadata(total_terms=-1).SerializeToString()
    assert neg == b"\x18" + b"\xff" * 9 + b"\x01"  # ten-byte varint
    assert tckpt.Metadata.FromString(neg).total_terms == -1


def test_sidecars_round_trip(tmp_path):
    class FakeCorpus:
        class vocab:
            terms = ["", "alpha", "beta"]
        docnos = ["d1", "d2"]
        stemmer = "krovetz"

    prefix = str(tmp_path / "m")
    tckpt.save_corpus_sidecars(FakeCorpus, prefix)
    assert tckpt.load_strings(f"{prefix}_vocab.txt") == ["", "alpha", "beta"]
    assert tckpt.load_strings(f"{prefix}_docnos.txt") == ["d1", "d2"]
    assert tckpt.load_strings(f"{prefix}_stemmer.txt") == ["krovetz"]


def _trained_state(seed=5):
    params = make_params(seed=seed)
    cfg = train_config()
    state = Optimizer(cfg).init(params)
    g = torch.Generator().manual_seed(seed)
    for s in state:
        for t in s:
            if t.dtype.is_floating_point:
                t.uniform_(0, 1, generator=g)
            else:
                t.fill_(7)
    return params, state, cfg


def test_resume_file_is_read_by_the_jax_loader(tmp_path):
    params, state, cfg = _trained_state()
    prefix = str(tmp_path / "m")
    tckpt.save_training_state(prefix, params, state, 3, extra={"total_batches": np.asarray(21)})
    jparams = JModelParams(*(np.zeros_like(a) for a in as_numpy(params)))
    jstate = JOptimizer(twin(cfg)).init(jparams)
    p2, s2, epoch, extra = jckpt.load_training_state(prefix, jparams, jstate)
    assert epoch == 3 and int(extra["total_batches"]) == 21
    for a, b in zip(params, p2):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    for ts, js in zip(state, s2):
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(np.asarray(b), a.numpy())
    assert int(s2.word.t) == 7


def test_resume_file_restores_in_place(tmp_path):
    params, state, cfg = _trained_state(seed=6)
    prefix = str(tmp_path / "m")
    tckpt.save_training_state(prefix, params, state, 2, extra={"total_batches": np.asarray(9)})
    fresh = make_params(seed=99)
    fresh_state = Optimizer(cfg).init(fresh)
    out_p, out_s, epoch, extra = tckpt.load_training_state(prefix, fresh, fresh_state)
    assert out_p is fresh and epoch == 2 and int(extra["total_batches"]) == 9
    for a, b in zip(tckpt.state_leaves(params, state), tckpt.state_leaves(fresh, fresh_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_training_state(prefix, make_params(rows=12), fresh_state)


class TestAsyncCheckpointWriter:
    def test_matches_sync_writes(self, tmp_path):
        params, state, _ = _trained_state(seed=7)
        sync, asyn = str(tmp_path / "sync"), str(tmp_path / "async")
        extra = {"total_batches": np.asarray(7)}
        tckpt.save_model_hdf5(params, sync, 3)
        tckpt.save_training_state(sync, params, state, 3, extra=extra)
        w = tckpt.AsyncCheckpointWriter()
        w.save_model(params, asyn, 3)
        w.save_training_state(asyn, params, state, 3, extra=extra)
        w.close()
        with open(f"{sync}_3.hdf5", "rb") as a, open(f"{asyn}_3.hdf5", "rb") as b:
            assert a.read() == b.read()
        with np.load(f"{sync}_resume.npz") as a, np.load(f"{asyn}_resume.npz") as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])

    def test_write_order_and_overwrite_guard(self, tmp_path):
        params = make_params()
        prefix = str(tmp_path / "m")
        w = tckpt.AsyncCheckpointWriter()
        w.save_model(params, prefix, 1)
        # The same epoch again without overwrite: the worker refuses it and
        # the error surfaces on wait().
        w.save_model(params, prefix, 1)
        with pytest.raises(FileExistsError):
            w.wait()
        # The writer stays usable after a propagated error.
        w.save_model(params, prefix, 2)
        w.close()
        assert tckpt.load_model_hdf5(prefix, 2, CPU) is not None

    def test_first_error_kept_and_raised_by_the_next_save(self, tmp_path):
        params = make_params()
        w = tckpt.AsyncCheckpointWriter(max_pending=4)
        gate = threading.Event()
        w._submit(gate.wait, (), {}, torch.device("cpu"))  # holds the worker
        w.save_model(params, str(tmp_path / "missing" / "a"), 1)  # no such directory
        w.save_model(params, str(tmp_path / "missing" / "b"), 1)
        gate.set()
        w._queue.join()
        with pytest.raises(FileNotFoundError, match="a_1"):
            w.save_model(params, str(tmp_path / "c"), 1)
        w.close()  # the second error was dropped with the first
        assert not os.path.exists(tmp_path / "c_1.hdf5")

    def test_close_raises_a_pending_error(self, tmp_path):
        w = tckpt.AsyncCheckpointWriter()
        w.save_model(make_params(), str(tmp_path / "missing" / "a"), 1)
        with pytest.raises(FileNotFoundError):
            w.close()
        assert not w._thread.is_alive()

    def test_snapshot_is_taken_at_submission(self, tmp_path):
        """The step updates the tables in place; a save submitted before an
        update must write the tables as they were."""
        params, state, _ = _trained_state(seed=8)
        before = [t.clone() for t in tckpt.state_leaves(params, state)]
        w = tckpt.AsyncCheckpointWriter(max_pending=1)
        w.save_model(params, str(tmp_path / "m"), 1)
        w.save_training_state(str(tmp_path / "m"), params, state, 1)
        for t in tckpt.state_leaves(params, state):
            t.add_(1)
        w.close()
        loaded = tckpt.load_model_hdf5(str(tmp_path / "m"), 1, CPU)
        for a, b in zip(before[:4], loaded):
            assert torch.equal(a, b)
        fresh = make_params(seed=0)
        fresh_state = Optimizer(train_config()).init(fresh)
        tckpt.load_training_state(str(tmp_path / "m"), fresh, fresh_state)
        for a, b in zip(before, tckpt.state_leaves(fresh, fresh_state)):
            assert torch.equal(a, b)


def test_snapshot_keeps_the_named_tuples():
    params, state, _ = _trained_state(seed=9)
    p, o = tckpt.AsyncCheckpointWriter._clone(params), tckpt.AsyncCheckpointWriter._clone(state)
    assert isinstance(p, ModelParams) and type(o) is type(state)
    for a, b in zip(tckpt.state_leaves(params, state), tckpt.state_leaves(p, o)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def _state_of(name, seed):
    cfg = optimizer_config(name)
    params = make_params(seed=seed)
    state = Optimizer(cfg).init(params)
    g = torch.Generator().manual_seed(seed)
    for s in state:
        for t in s:
            if t.dtype.is_floating_point:
                t.uniform_(0, 1, generator=g)
            else:
                t.fill_(seed)
    return params, state, cfg


@pytest.mark.parametrize("name", sorted(UPDATE_METHOD_NAMES))
def test_resume_file_of_every_optimizer_is_read_by_the_jax_loader(tmp_path, name):
    params, state, cfg = _state_of(name, 11)
    prefix = str(tmp_path / "m")
    tckpt.save_training_state(prefix, params, state, 4, extra={"total_batches": np.asarray(8)})
    jparams = JModelParams(*(np.zeros_like(a) for a in as_numpy(params)))
    jstate = JOptimizer(twin(cfg)).init(jparams)
    p2, s2, epoch, extra = jckpt.load_training_state(prefix, jparams, jstate)
    assert epoch == 4 and int(extra["total_batches"]) == 8
    for a, b in zip(tckpt.state_leaves(params, state),
                    [*p2, *(leaf for sub in s2 for leaf in sub)]):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    assert [type(s).__name__ for s in s2] == [type(s).__name__ for s in state]


@pytest.mark.parametrize("name", sorted(UPDATE_METHOD_NAMES))
def test_port_reads_the_jax_resume_file_of_every_optimizer(tmp_path, name):
    src_params, src_state, cfg = _state_of(name, 12)
    jparams = JModelParams(*as_numpy(src_params))
    jstate = type(src_state)(*(type(s)(*(t.numpy() for t in s)) for s in src_state))
    prefix = str(tmp_path / "j")
    jckpt.save_training_state(prefix, jparams, jstate, 6, extra={"total_batches": np.asarray(3)})
    fresh = make_params(seed=99)
    fresh_state = Optimizer(cfg).init(fresh)
    _, _, epoch, extra = tckpt.load_training_state(prefix, fresh, fresh_state)
    assert epoch == 6 and int(extra["total_batches"]) == 3
    for a, b in zip(tckpt.state_leaves(src_params, src_state),
                    tckpt.state_leaves(fresh, fresh_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
