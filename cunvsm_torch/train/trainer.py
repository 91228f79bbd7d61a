"""Epoch loop for every objective, host-fed or (text-entity only) sampled
on the device, with HDF5 checkpoints and resume.

Port of the single-device paths of ``cunvsm_tpu/train/trainer.py``:

* **host-fed**: batches come from ``data.instances.TextEntitySource`` on
  the host, assembled and copied to ``device`` on a prefetch thread
  (``data.sources.Prefetcher``); a composite objective zips them in
  lockstep with an endlessly repeating ``similarity_source`` (the text
  stream paces the epoch, main.cu:256-258);
* **on-device sampling** (``on_device_sampling=True``): the corpus lives on
  the device and every call of ``steps_per_call`` steps samples its own
  batches from the epoch's shuffled pointers (``data.device_sampler``).
  An epoch is ``steps_epoch = max(min(batches, pointers // B), 1)`` steps:
  ``steps_epoch // K`` calls of K steps, then one call of the remainder,
  so every full batch trains once per epoch.

The per-step costs stay on the device until one read per epoch.  With an
``output_prefix`` the loop writes ``<prefix>_meta`` and the vocabulary and
docno sidecars once, and at every ``checkpoint_every``-th epoch (and the
last) ``<prefix>_<epoch>.hdf5`` and ``<prefix>_resume.npz``, all through an
``AsyncCheckpointWriter``.

Random streams.  The JAX package derives the epoch's permutation key from
the epoch and each call's step key from the count of steps trained
(``total_batches``).  This package does the same with one explicit
``torch.Generator`` on ``device``, reseeded from
``derived_seed(cfg.seed, stream, counter)``: from (seed,
``PERMUTATION_STREAM``, epoch) before the epoch's shuffle, and from (seed,
``STEP_STREAM``, total_batches) before each call, whose steps then draw
their window placements and negatives in order.  Parameters are
Glorot-initialized from the generator seeded with ``cfg.seed``.  A resumed
run therefore draws what an uninterrupted run would have drawn; the
host-fed path replays its numpy batch stream with
``TextEntitySource.skip_epochs`` and fast-forwards the similarity stream
past the batches already trained.

Reference-RNG replay (``cfg.reference_rng``, host-fed only) draws what the
CUDA reference draws, from one host ``minstd_rand0`` stream seeded with
``cfg.seed``, in its order: epoch 1's window positions and shuffle, the
Glorot init (``reference_init_params``), then per batch the negatives,
which ride in the batch; ``skip_epochs`` replays the stream on resume.

``compute_initial_cost`` scores one host epoch forward-only before
training (main.cu:544-562), each batch's draws from (seed,
``INITIAL_COST_STREAM``, batch); like the JAX package's, it consumes that
epoch of the host source, so training starts at the next draw.
``profile_dir`` records the second trained epoch (the only one of a
one-epoch run) with ``torch.profiler`` and writes a Chrome trace there,
which holds the ``cunvsm.`` spans of ``spans.py`` beside torch's
operations; ``check_gradients`` holds every host-fed
step's gradients to central finite differences first
(``train/gradcheck.py``; under a mesh the mesh step's gradients, put
together into full tables, against differences of the global cost).

Under a mesh (``mesh=``, a ``parallel.mesh.Mesh``; one process per device,
every process calls ``train_model`` with the same arguments) the entity
table and its optimizer state are sharded by rows over the model axis,
zero-padded to a multiple of it, and the batch rows are split over the data
axis.  Every rank initializes the full tables from the same seed and keeps
its rows, builds the same host batches or draws the same device batches and
keeps its rows, so a mesh run consumes the stream of the single-device run
of that seed.  ``shard_corpus`` instead gives each data group its own part
of the device corpus and its own shuffle (``data/device_sampler.py``), and
``stratify_data_groups`` reproduces that batch composition on one device.
At a dump every rank takes part in fetching the snapshot, on the training
thread (a collective); the primary alone hands it to the writer, and
alone writes ``_meta`` and the sidecars.  The model file holds the real
entity rows; the resume file keeps the padded layout, which every rank
loads and cuts again.  ``TrainResult`` holds the rank's shards
(``parallel.mesh.fetch_params`` puts them together).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from cunvsm_torch.config import AdamMode, ModelDesc, TrainConfig, UpdateMethod
from cunvsm_torch.data import device_sampler
from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.device_sampler import derived_seed
from cunvsm_torch.data.instances import FeatureWeighting, TextEntitySource, Weighting
from cunvsm_torch.data.sources import Prefetcher, SimilaritySource, repeating, zip_sources
from cunvsm_torch.io import checkpoint as ckpt
from cunvsm_torch.models.objectives import SimilarityBatch, TextEntityBatch
from cunvsm_torch.models.params import ModelParams, init_params, reference_init_params
from cunvsm_torch.optim.updates import Optimizer, OptState
from cunvsm_torch.parallel import distributed, mesh as pmesh
from cunvsm_torch.spans import span
from cunvsm_torch.train import gradcheck
from cunvsm_torch.train.step import (
    ObjectiveKind,
    make_cost_fn,
    make_train_step,
    objective_kind_from_config,
    resolve_negative_sampling,
)

logger = logging.getLogger(__name__)

PERMUTATION_STREAM = 0x5A5A5A  # the JAX package's fold_in tag of the shuffle
STEP_STREAM = 1
INITIAL_COST_STREAM = 0x7FFFFFFF  # the JAX package's tag of the initial-cost keys


@dataclasses.dataclass
class TrainResult:
    params: ModelParams
    opt_state: OptState
    epoch_costs: List[float]
    steps: int  # steps trained by this call
    batches_per_sec: float  # steps / wall seconds of this call's epochs


def _check_options(cfg, kind, on_device_sampling, steps_per_call, checkpoint_every,
                   similarity_source, mesh, shard_corpus, stratify_data_groups,
                   check_gradients, compute_initial_cost):
    """The JAX trainer's guards as ValueErrors with its conditions."""
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if cfg.reference_rng and on_device_sampling:
        raise ValueError(
            "reference_rng replays the host minstd_rand0 pipeline; "
            "on_device_sampling draws on device — pick one"
        )
    if cfg.reference_rng and cfg.no_shuffle:
        raise ValueError("reference_rng replay covers the stochastic generator")
    if kind != ObjectiveKind.TEXT_ENTITY and similarity_source is None:
        raise ValueError(f"objective {kind} requires a similarity source")
    if cfg.reference_rng and compute_initial_cost:
        raise ValueError(
            "reference_rng does not replay the initial-cost pass's "
            "label draws (main.cu:544-562); disable "
            "compute_initial_cost under reference_rng"
        )
    if stratify_data_groups and not on_device_sampling:
        raise ValueError("stratify_data_groups requires on_device_sampling")
    if on_device_sampling:
        if kind != ObjectiveKind.TEXT_ENTITY:
            raise ValueError("on-device sampling supports only the text-entity objective")
        if cfg.no_shuffle:
            raise ValueError("on-device sampling is stochastic-only")
        if check_gradients:
            raise ValueError("check_gradients is incompatible with on-device sampling")
        if shard_corpus and mesh is None:
            raise ValueError("shard_corpus requires a mesh")
        if stratify_data_groups and shard_corpus:
            raise ValueError(
                "stratify_data_groups simulates the shard_corpus shuffle "
                "on an unsharded corpus; pick one"
            )
    elif steps_per_call > 1 and check_gradients:
        raise ValueError("check_gradients requires steps_per_call=1")
    if mesh is not None:
        if mesh.size != distributed.process_count():
            raise ValueError(
                f"mesh {mesh.data}x{mesh.model} needs {mesh.size} processes; the "
                f"process group has {distributed.process_count()}"
            )
        if cfg.batch_size % mesh.data:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by data axis {mesh.data}"
            )
        # The full_adam word accumulation splits the update stream over
        # every mesh axis: fail here, not inside the first step.
        if (
            cfg.update_method == UpdateMethod.ADAM
            and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE
            and cfg.batch_size % mesh.size
        ):
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the total "
                f"device count {mesh.size} (mesh "
                f"{mesh.data}x{mesh.model}): the full_adam word "
                f"accumulation shards the update stream over every mesh "
                f"axis"
            )


def negative_layout(cfg: TrainConfig, desc: ModelDesc, num_entities: int) -> str:
    """The negative sampling that ``cfg`` resolves to at its batch size."""
    pool, stride = resolve_negative_sampling(cfg, desc, cfg.batch_size, num_entities)
    if cfg.shared_negatives:
        return f"batch-shared (k={cfg.num_random_entities})"
    if pool:
        return f"rolled pool P={pool} stride={stride} (k={cfg.num_random_entities})"
    return f"per-instance (k={cfg.num_random_entities})"


def _log_initial_cost(desc, cfg, kind, device, generator, params, batches,
                      num_entities=None, mesh=None) -> None:
    """main.cu:544-562: the mean forward-only cost over one host epoch,
    logged as ``Initial cost``; batch i draws from (seed,
    INITIAL_COST_STREAM, i)."""
    start = time.perf_counter()
    cost_fn = make_cost_fn(desc, cfg, kind, device, generator, num_entities, mesh)
    costs = []
    for i, batch in enumerate(batches):
        generator.manual_seed(derived_seed(cfg.seed, INITIAL_COST_STREAM, i))
        costs.append(cost_fn(params, batch).reshape(1))
    if costs:
        logger.info("Initial cost: %.6f (%d batches, %.3fs)", float(torch.cat(costs).mean()),
                    len(costs), time.perf_counter() - start)


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, epoch: int) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    logger.info("Profile of epoch %d written to %s.", epoch, path)


def _waited(batches):
    """``batches``, each wait for the next one a ``cunvsm.trainer.wait_batch``
    span."""
    batches = iter(batches)
    while True:
        with span("cunvsm.trainer.wait_batch"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


def train_model(
    desc: ModelDesc,
    cfg: TrainConfig,
    corpus: Corpus,
    device,
    output_prefix: Optional[str] = None,
    similarity_source: Optional[SimilaritySource] = None,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
    weighting: Weighting = Weighting.AUTOMATIC,
    compute_initial_cost: bool = False,
    dump_initial_model: bool = False,
    dump_every: int = 0,
    resume: bool = False,
    prefetch_depth: int = 10,
    dtype=torch.float32,
    epoch_callback: Optional[Callable] = None,
    check_gradients: bool = False,
    profile_dir: Optional[str] = None,
    log_every: int = 0,
    steps_per_call: int = 1,
    mesh=None,
    on_device_sampling: bool = False,
    shard_corpus: bool = False,
    stratify_data_groups: int = 0,
    checkpoint_every: int = 1,
) -> TrainResult:
    """Train a model over ``corpus`` for ``cfg.num_epochs`` epochs on
    ``device``; the options are the JAX trainer's (see the module doc).
    The objective follows the mixture weights of ``cfg``; a composite needs
    ``similarity_source`` (``data.sources.SimilaritySource``), whose pairs
    index the entity table (entity-entity) or the word table (term-term).

    ``steps_per_call`` is the K of the on-device path; the host-fed path
    reseeds its generator per call of K steps as the JAX package keys its
    groups, and enqueues each step as its batch arrives.  ``dump_every``
    and ``log_every`` count steps of the host-fed path.  ``resume`` restarts
    after the last epoch in ``<output_prefix>_resume.npz`` (and trains from
    scratch without one).  ``epoch_callback(epoch, params, cost)`` runs
    after each epoch, once that epoch's checkpoint is on disk.
    """
    kind = objective_kind_from_config(cfg)
    _check_options(cfg, kind, on_device_sampling, steps_per_call, checkpoint_every,
                   similarity_source, mesh, shard_corpus, stratify_data_groups,
                   check_gradients, compute_initial_cost)
    # UNIFORM feature weighting means every batch's feature_weights are all
    # ones: promise that statically so the step skips the multiply.
    if feature_weighting == FeatureWeighting.UNIFORM:
        cfg = dataclasses.replace(cfg, uniform_feature_weights=True)
    elif cfg.uniform_feature_weights:
        raise ValueError("uniform_feature_weights requires UNIFORM feature weighting")
    source = TextEntitySource(
        corpus,
        batch_size=cfg.batch_size,
        shuffle=not cfg.no_shuffle,
        weighting=weighting,
        feature_weighting=feature_weighting,
        seed=cfg.seed,
        reference_rng=cfg.reference_rng,
        num_negative=cfg.num_random_entities if cfg.reference_rng else 0,
    )
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    # Every rank makes the full tables from the same seed (the stream of
    # the single-device run), then keeps its rows.
    if cfg.reference_rng:
        # The reference draws epoch 1's positions and shuffle in the
        # generator's constructor (data_indri.cpp:279,328-398), then the
        # Glorot init from the same engine (main.cu:499,520).
        source.draw_next_epoch()
        params = reference_init_params(
            source.std_rng, corpus.vocab.size, corpus.num_docs, desc, dtype=dtype,
            device=device,
        )
    else:
        params = init_params(
            generator, corpus.vocab.size, corpus.num_docs, desc, dtype=dtype, device=device
        )
    if mesh is not None:
        params = pmesh.shard_params(mesh, params)
    opt_state = Optimizer(cfg).init(params)
    primary = distributed.is_primary()

    def reseed(stream: int, counter: int) -> None:
        generator.manual_seed(derived_seed(cfg.seed, stream, counter))

    start_epoch, total_batches = 1, 0
    if resume and output_prefix and os.path.exists(f"{output_prefix}_resume.npz"):
        # The file keeps the padded layout; a rank cuts its rows from it.
        rows = None
        if mesh is not None:
            padded = pmesh.pad_entities(corpus.num_docs, mesh.model)
            rows = (padded, mesh.entity_rows(padded))
        _, _, last_epoch, extra = ckpt.load_training_state(
            output_prefix, params, opt_state, shard_rows=rows
        )
        start_epoch = last_epoch + 1
        total_batches = int(extra.get("total_batches", 0))
        if not on_device_sampling or compute_initial_cost:
            source.skip_epochs(last_epoch)
        logger.info("Resumed from epoch %d at step %d.", last_epoch, total_batches)
    sim_iter = iter(repeating(similarity_source)) if similarity_source is not None else None
    if sim_iter is not None:
        # Fast-forward the similarity stream past the batches trained.
        for _ in range(total_batches):
            next(sim_iter)
    logger.info("Negative sampling: %s.", negative_layout(cfg, desc, corpus.num_docs))

    if output_prefix and start_epoch == 1 and primary:
        # One-time metadata and sidecars (main.cu:527-537); one process
        # writes.
        ckpt.save_meta(
            ckpt.build_metadata(
                corpus.vocab.index_term_ids, corpus.vocab.term_freq, corpus.num_docs,
                corpus.vocab.total_terms, corpus.vocab.include_oov,
                index_object_ids=getattr(corpus, "index_doc_ids", None),
            ),
            output_prefix,
        )
        ckpt.save_corpus_sidecars(corpus, output_prefix)

    k = max(steps_per_call, 1)
    if on_device_sampling:
        resolved = Weighting.UNIFORM if weighting == Weighting.AUTOMATIC else weighting
        if shard_corpus:
            # Each data group holds its own documents' tokens and shuffles
            # its own pointers.
            dc = device_sampler.prepare_sharded_device_corpus(
                corpus, mesh, device, weighting=resolved, feature_weighting=feature_weighting
            )
            permute, ptrs_per_epoch = device_sampler.make_sharded_epoch_permuter(dc)
        else:
            dc = device_sampler.prepare_device_corpus(
                corpus, device, weighting=resolved, feature_weighting=feature_weighting
            )
            if stratify_data_groups:
                permute, ptrs_per_epoch = device_sampler.make_stratified_epoch_permuter(
                    dc, stratify_data_groups, cfg.batch_size
                )
            else:
                permute, ptrs_per_epoch = device_sampler.make_epoch_permuter(dc)
        steps_epoch = max(min(source.batches_per_epoch(), ptrs_per_epoch // cfg.batch_size), 1)
        k = min(k, steps_epoch)
        rem_steps = steps_epoch % k
        if rem_steps:
            logger.warning(
                "steps_per_call=%d does not divide the epoch's %d steps; the %d "
                "remainder steps run as one extra call per epoch.",
                k, steps_epoch, rem_steps,
            )
        calls = [(k, steps_epoch // k)] + ([(rem_steps, 1)] if rem_steps else [])
        runs = []
        for n, count in calls:
            if shard_corpus:
                run = device_sampler.make_corpus_sharded_multistep(
                    desc, cfg, dc, n, mesh, generator, num_entities=corpus.num_docs
                )
            elif mesh is not None:
                run = device_sampler.make_device_sampled_sharded_multistep(
                    desc, cfg, dc, n, mesh, generator, num_entities=corpus.num_docs
                )
            else:
                run = device_sampler.make_device_sampled_multistep(
                    desc, cfg, dc, n, generator, num_entities=corpus.num_docs
                )
            runs += [(run, n)] * count
    else:
        step = make_train_step(
            desc, cfg, device, generator, num_entities=corpus.num_docs, mesh=mesh
        )
        batches_per_epoch = source.batches_per_epoch()
        grouped = batches_per_epoch // k * k  # later steps run as calls of one

    # The host batches' weights stay float32 on the device, as the JAX
    # trainer's do, so a float64 run rounds the NCE weights as JAX does.
    def to_device(b):
        if mesh is not None:
            # Every rank builds the global batch; its rows alone are copied.
            b = pmesh.local_batch(mesh, b)
        if kind == ObjectiveKind.TEXT_ENTITY:
            return TextEntityBatch.from_numpy(b, device)
        te, sim = b
        return (TextEntityBatch.from_numpy(te, device), SimilarityBatch.from_numpy(sim, device))

    def host_batches():
        batches = source.epoch_batches()
        if kind != ObjectiveKind.TEXT_ENTITY:
            batches = zip_sources(batches, sim_iter)
        batches = (to_device(b) for b in batches)
        return Prefetcher(batches, depth=prefetch_depth) if prefetch_depth > 0 else batches

    if compute_initial_cost:
        _log_initial_cost(desc, cfg, kind, device, generator, params, host_batches(),
                          corpus.num_docs, mesh)
    writer = ckpt.AsyncCheckpointWriter() if output_prefix and primary else None
    # The profiler traces the second trained epoch (the first builds the
    # kernels and loads torch's lazy modules), or the only one.
    profiled_epoch = min(start_epoch + 1, cfg.num_epochs) if profile_dir and primary else None
    profiler = None

    def save_model(tag, overwrite=False):
        """Every rank fetches (a collective); the primary writes the real
        entity rows."""
        full = params
        if mesh is not None:
            full = pmesh.fetch_params(mesh, params, corpus.num_docs)
        if writer is not None:
            writer.save_model(full, output_prefix, tag, overwrite=overwrite)

    def save_training_state(epoch):
        full, full_state = params, opt_state
        if mesh is not None:
            full = pmesh.fetch_params(mesh, params)
            full_state = pmesh.fetch_opt_state(mesh, opt_state)
        if writer is not None:
            writer.save_training_state(
                output_prefix, full, full_state, epoch,
                extra={"total_batches": np.asarray(total_batches)},
            )

    epoch_costs: List[float] = []
    steps = 0
    train_start = time.perf_counter()
    try:
        if dump_initial_model and output_prefix:
            save_model(0)
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            if epoch == profiled_epoch:
                profiler = _start_profiler(device)
            with span("cunvsm.trainer.epoch"):
                epoch_start = time.perf_counter()
                costs = []
                if on_device_sampling:
                    with span("cunvsm.trainer.permute"):
                        reseed(PERMUTATION_STREAM, epoch)
                        doc_perm = permute(generator)
                    cursor = 0
                    for run, n in runs:
                        with span("cunvsm.trainer.call"):
                            reseed(STEP_STREAM, total_batches)
                            costs.append(run(params, opt_state, doc_perm, cursor))
                        cursor += n * cfg.batch_size
                        total_batches += n
                else:
                    for i, batch in enumerate(_waited(host_batches())):
                        if i % k == 0 or i >= grouped:
                            reseed(STEP_STREAM, total_batches)
                        if check_gradients:
                            gradcheck.check_gradients(kind, params, batch, generator, device,
                                                      desc, cfg, num_entities=corpus.num_docs,
                                                      mesh=mesh)
                        with span("cunvsm.trainer.call"):
                            cost = step(params, opt_state, batch)
                        costs.append(cost.reshape(1))
                        total_batches += 1
                        if log_every and total_batches % log_every == 0:
                            logger.info("Batch %d (epoch %d): cost=%.6f progress=%.1f%%",
                                        total_batches, epoch, float(cost),
                                        100.0 * (i + 1) / max(batches_per_epoch, 1))
                        if dump_every > 0 and output_prefix and total_batches % dump_every == 0:
                            save_model(f"{epoch}_{total_batches}")
                epoch_steps = sum(c.shape[0] for c in costs)
                steps += epoch_steps
                # One host read per epoch.
                with span("cunvsm.trainer.cost_read"):
                    epoch_cost = float(torch.cat(costs).mean()) if costs else 0.0
                epoch_costs.append(epoch_cost)
                logger.info("Epoch %d%s: cost=%.6f (%d steps, %.1fs)", epoch,
                            " (on-device sampling)" if on_device_sampling else "",
                            epoch_cost, epoch_steps, time.perf_counter() - epoch_start)
            # The epoch's span closes with its cost read, before the
            # profiler stops: a span still open then is dropped from its
            # trace (torch 2.11).
            if profiler is not None:
                _stop_profiler(profiler, profile_dir, epoch)
                profiler = None
            dumped = output_prefix and (epoch % checkpoint_every == 0 or epoch == cfg.num_epochs)
            if dumped:
                save_model(epoch, overwrite=resume)
                save_training_state(epoch)
            if epoch_callback:
                if dumped:
                    # Callbacks read this epoch's files: wait for the
                    # writer, and the other ranks for the primary.
                    if writer is not None:
                        writer.wait()
                    if mesh is not None:
                        distributed.barrier(device)
                epoch_callback(epoch, params, epoch_cost)
    finally:
        if profiler is not None:
            profiler.stop()
        if writer is not None:
            writer.close()
    if mesh is not None and output_prefix:
        # The primary's files are on disk before any rank returns: a run
        # that resumes them may follow at once, on every rank.
        distributed.barrier(device)
    total_time = time.perf_counter() - train_start
    return TrainResult(
        params, opt_state, epoch_costs, steps,
        batches_per_sec=steps / total_time if total_time > 0 else 0.0,
    )
