"""BENCHMARK.json against the benchmark's contract, the result line's shape,
the import rules, the refusals, and a cell added by files alone."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

from nvsm_bench import harness
from nvsm_bench.harness import Record

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keys_and_names(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "nvsm_bench/run.py"]
    assert bench["paths"] == ["nvsm_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"nvsm_bench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == harness.load_json("configs", f"{c['name']}.json")["reduced"]
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(harness.HERE, "workloads", f"{w['name']}.json"))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert hasattr(harness.metric_reader(m["name"]), "read")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_result_line_shape(bench, tiny):
    ctx = tiny("nvsm.train")
    rec = Record(end_to_end={"train_pairs_per_s": 6.5e6, "setup_s": 9.0}, attempted=10,
                 failed=0, memory_peak_bytes=123, checks=[("loss_gap_e1", 1e-7, 1e-3)],
                 faults=[])
    line = harness.result_line(ctx, rec, "NVIDIA H100 80GB HBM3", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"train_pairs_per_s": {"value": 6.5e6, "unit": "pairs/s"},
                               "setup_s": {"value": 9.0, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["checks"] == {"loss_gap_e1": {"value": 1e-7, "limit": 1e-3}}
    json.dumps(line)
    assert harness.check_lines(rec) == ["check loss_gap_e1 1e-07 limit 0.001 ok"]
    bad = Record(end_to_end={"setup_s": 9.0}, attempted=10, failed=0, memory_peak_bytes=1,
                 checks=[("loss_gap_e1", float("nan"), 1e-3)], faults=[])
    line = harness.result_line(ctx, bad, "x", 1)
    assert line["correct"] is False and "train_pairs_per_s" not in line["metrics"]
    assert line["checks"]["faults"] == {"value": 1, "limit": 0}


def test_forbidden_module_audit_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cunvsm_tpu_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = set(_imports(path))
                assert not tops & {"jax", "jaxlib", "flax", "cunvsm_tpu"}, path
                if os.sep + "reference" + os.sep in path:
                    assert "cunvsm_torch" not in tops, path


def test_a_run_imports_no_jax(tiny):
    """What a run loads: the harness, every driver, reader and reference,
    and the program modules the drivers call."""
    code = (
        "import sys, time, json, torch; sys.path.insert(0, %r)\n"
        "from nvsm_bench import harness\n"
        "bench = json.load(open(%r))\n"
        "for w in bench['workloads']:\n"
        "    ctx = harness.Context.load(bench, w['name'], seed=1, seconds=0, trace=False,\n"
        "        device=torch.device('cpu'), start=time.perf_counter())\n"
        "    ctx.driver()\n"
        "    for m in bench['per_layer']: harness.metric_reader(m['name'])\n"
        "import cunvsm_torch.train.trainer, cunvsm_torch.query.engine, cunvsm_torch.data.synth\n"
        "print(harness.forbidden_modules())\n"
    ) % (ROOT, os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_2_and_prints_nothing(tmp_path):
    cmd = [sys.executable, "nvsm_bench/run.py", "--workload", "nvsm.train", "--seed",
           str(2**31 + 7), "--seconds", "1", "--trace", "0"]
    # No bytecode cache under the checkout from a test.
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1"}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 2 and out.stdout == ""
    # A directory with only BENCHMARK.json and the benchmark's files.
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "nvsm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_added_by_files_alone_is_found(tmp_path, bench, tiny, monkeypatch):
    """A copy of the benchmark gains a traffic mix, a cell's file and a
    BENCHMARK.json entry; the harness runs the new cell unedited."""
    copy = tmp_path / "nvsm_bench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((copy / "traffic" / "train_on_device.json").read_text())
    mix.update(steps_per_call=5)
    (copy / "traffic" / "train_k5.json").write_text(json.dumps(mix))
    (copy / "workloads" / "nvsm.train_k5.json").write_text(
        (copy / "workloads" / "nvsm.train.json").read_text())
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": "nvsm.train_k5", "config": "nvsm", "traffic": "train_k5", "chips": 1,
         "why": "a test cell"}])
    monkeypatch.setattr(harness, "HERE", str(copy))
    ctx = tiny("nvsm.train_k5", seconds=0.0, bench_=bench)
    assert ctx.mix["steps_per_call"] == 5
    rec = ctx.driver().run(ctx)
    assert rec.correct and rec.attempted == 24
