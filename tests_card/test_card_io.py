"""The async checkpoint writer and the query command on the card."""

import json

import numpy as np
import pytest
import torch

from cunvsm_torch.cli import query as tquery
from cunvsm_torch.cli import train as ttrain
from cunvsm_torch.config import ModelDesc
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.io.trec import read_run
from cunvsm_torch.models.params import init_params

TOPICS = {
    "space": "rocket orbit launch satellite astronaut".split(),
    "food": "recipe oven flour butter bake".split(),
    "sport": "goal match player referee stadium".split(),
}
EPOCHS = 4
TRAIN_FLAGS = [
    "--num_epochs", str(EPOCHS), "--batch_size", "16", "--window_size", "4",
    "--num_random_entities", "3", "--word_repr_size", "10", "--entity_repr_size", "8",
    "--update_method", "full_adam", "--nonlinearity", "tanh", "--max_vocabulary_size", "0",
    "--min_document_frequency", "0", "--max_document_frequency", "0", "--seed", "3",
    "--learning_rate", "0.02", "--reference_rng",
]
QUERIES = [("1", "rocket orbits launched"), ("2", "the oven baking butter"),
           ("3", "referee and players"), ("4", "nothing known here")]


@pytest.mark.cuda
def test_async_writer_snapshots_card_tensors_at_submission(cuda, tmp_path):
    """On the card the clone is enqueued on the training stream and the
    worker copies it to the host on its own stream after an event."""
    desc = ModelDesc(word_repr_size=7, entity_repr_size=5)
    params = init_params(torch.Generator().manual_seed(10), 4096, 8192, desc,
                         dtype=torch.float32, device="cpu")
    params = type(params)(*(t.cuda() for t in params))
    before = [t.cpu() for t in params]
    w = tckpt.AsyncCheckpointWriter()
    for epoch in range(3):
        w.save_model(params, str(tmp_path / "m"), epoch)
        for t in params:
            t.mul_(2.0)  # in place, as the step does
    w.close()
    for epoch in range(3):
        loaded = tckpt.load_model_hdf5(str(tmp_path / "m"), epoch, "cpu")
        for a, b in zip(before, loaded):
            assert torch.equal(a * 2.0 ** epoch, b)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A model trained by the train command on the CPU from a three-topic
    JSONL corpus."""
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("model")
    with open(d / "docs.jsonl", "w") as f:
        for topic, words in TOPICS.items():
            for i in range(4):
                body = " ".join(words[rng.randint(len(words))] if rng.rand() < 0.8 else "the"
                                for _ in range(16))
                f.write(json.dumps({"id": f"{topic}_{i}", "text": body}) + "\n")
    prefix = str(d / "m")
    assert ttrain.main([str(d / "docs.jsonl"), "--output", prefix, "--device", "cpu",
                        *TRAIN_FLAGS]) == 0
    return prefix


@pytest.mark.cuda
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_query_command_on_card_matches_cpu(cuda, model, tmp_path, score_dtype):
    topics = tmp_path / "topics.txt"
    topics.write_text("".join(f"{q};{text}\n" for q, text in QUERIES))
    common = ["--topics", str(topics), "--model", model, "--epoch", str(EPOCHS),
              "--score_dtype", score_dtype]
    for device in ("cpu", "cuda"):
        assert tquery.main([*common, "--device", device, str(tmp_path / device)]) == 0
    cpu, card = read_run(str(tmp_path / "cpu")), read_run(str(tmp_path / "cuda"))
    assert card.keys() == cpu.keys()
    for q in cpu:
        assert len(card[q]) == len(cpu[q])
        assert [d for d, _ in card[q][:10]] == [d for d, _ in cpu[q][:10]], q
        np.testing.assert_allclose([s for _, s in card[q]], [s for _, s in cpu[q]],
                                   rtol=0, atol=1e-5)
