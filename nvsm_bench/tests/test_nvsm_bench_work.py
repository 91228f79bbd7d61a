"""The yardstick's counts and peaks against the numbers the cells were
defined with."""

import pytest

from nvsm_bench import harness, yardstick


def lse_sizes():
    """The text-entity counts at the CIKM 2016 LSE's sizes (batch 4,096,
    65,536 products, float32 streams), a configuration for a later cell."""
    cfg = harness.load_json("configs", "nvsm.json")
    cfg["train"].update(batch_size=4096, stream_dtype="float32")
    cfg["collection"].update(num_docs=65536)
    return cfg


@pytest.fixture(params=["nvsm", "lse"])
def config(request):
    if request.param == "lse":
        return "lse", lse_sizes()
    return "nvsm", harness.load_json("configs", "nvsm.json")


def work(name):
    return harness.load_module("work", "text_entity.py")


def test_train_step_flops(config):
    name, cfg = config
    expected = {"nvsm": 24_458_035_200, "lse": 1_956_642_816}[name]
    assert work(name).train_step_flops(cfg) == expected
    assert round(expected / 1e9, 2 if name == "nvsm" else 3) == {"nvsm": 24.46, "lse": 1.957}[name]


def test_sweep_elements_and_bound(config):
    name, cfg = config
    elements = {"nvsm": 86_769_664, "lse": 36_438_016}[name]
    assert work(name).sweep_elements(cfg) == elements
    seconds, by = yardstick.bound(*work(name).sweep(cfg))
    assert by == "bytes"
    assert seconds == pytest.approx({"nvsm": 0.725e-3, "lse": 0.305e-3}[name], rel=2e-3)


def test_cast_only_under_bfloat16_streams(config):
    name, cfg = config
    cast = work(name).cast(cfg)
    if name == "lse":
        assert cast is None
        return
    num_bytes, ops = cast
    assert num_bytes == 6 * 19_660_800 and ops == 19_660_800
    assert yardstick.bound(num_bytes, ops)[0] == pytest.approx(0.0352e-3, rel=2e-3)


def test_busy_union_and_quantile():
    assert yardstick.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert yardstick.quantile([3.0], 95) == 3.0
    assert yardstick.quantile(list(range(1, 101)), 50) == pytest.approx(50.5)


def test_trace_summary_reads_kernels_and_labels_gaps():
    device = [(0.0, 1.0, "_sweep_body"), (1.0, 1.5, "cast_kernel(float const*)"),
              (3.0, 4.0, "_sweep_body")]
    host = [(0.5, 3.5, "aten::outer"), (1.6, 2.9, "aten::item")]
    t = yardstick.TraceSummary(device, host, wall_s=5.0, units=2)
    assert t.busy_s == 2.5
    assert t.matching("_sweep_body") == (2.0, 2)
    assert t.top_device_ops()[0] == ["_sweep_body", 2.0]
    assert t.idle_gaps() == [["host: aten::item", 1.5]]
    assert yardstick.idle_share(t, 2.5) == pytest.approx(50.0)
    assert yardstick.idle_share(t, None) is None
