"""BENCHMARK.json against the limits of its format, and discovery by file name."""

import ast
import glob
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    for e in BENCH["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["moves"] in e2e and 1 <= len(e["layer"]) <= 200
        assert set(e.get("workloads", CELLS)) <= set(CELLS)
        if e["name"].endswith("_roofline"):
            assert e["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and c["reduced"] == [] and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_file_name(cell):
    c = harness.resolve(cell)
    assert c.config["stark"]["expansion_factor"] == 4 and c.traffic["loop"] == "closed"
    assert {m["name"] for m, _ in c.end_to_end} >= {"prove_s", "setup_s"}
    assert c.per_layer and all(callable(read) for _, read in c.per_layer)
    for e in BENCH["per_layer"]:
        assert (e["name"] in {m["name"] for m, _ in c.per_layer}) == (cell in e.get("workloads", CELLS))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(harness.BENCH_DIR, "metrics", "*.py"))}
    assert readers == {e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]}


def test_kernel_attributions_name_roofline_metrics():
    kernels = harness.kernel_metrics()
    assert kernels["ntt_stage_kernel"] == "ntt_roofline" and kernels["blake2b_planes_kernel"] == "blake2b_roofline"
    rooflines = {e["name"] for e in BENCH["per_layer"] if e["name"].endswith("_roofline")}
    assert set(kernels.values()) == rooflines


def test_a_new_metric_or_kernel_is_a_new_file(tmp_path, monkeypatch):
    for sub in ("metrics", "kernels"):
        os.makedirs(tmp_path / sub)
    (tmp_path / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return ctx['proves'] * 2\n")
    (tmp_path / "kernels" / "new_kernel.json").write_text('{"metric": "new_roofline"}')
    monkeypatch.setattr(harness, "BENCH_DIR", str(tmp_path))
    assert harness._reader("new_metric")({"proves": 3}) == 6
    assert harness.kernel_metrics() == {"new_kernel": "new_roofline"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_import_check_compares_top_level_names_whole():
    assert harness.FORBIDDEN_MODULES == ("jax", "jaxlib", "flax", "stark_anatomy_tpu")
    # the program's name begins with the JAX package's; only a whole name counts
    assert "stark_anatomy_tpu_torch".split(".")[0] not in harness.FORBIDDEN_MODULES
    files = glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"), recursive=True)
    assert files
    for path in files:
        found = set(_imports(path))
        assert not found & set(harness.FORBIDDEN_MODULES), path
        if os.sep + "reference" + os.sep in path:
            assert "stark_anatomy_tpu_torch" not in found, path


def test_foreign_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "stark_anatomy_tpu_torch_fake", types.ModuleType("x"))
    assert "stark_anatomy_tpu" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "stark_anatomy_tpu.ops", types.ModuleType("x"))
    assert "stark_anatomy_tpu" in harness.foreign_modules()
