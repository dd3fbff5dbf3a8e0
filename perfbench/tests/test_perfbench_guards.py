"""The benchmark's own rules, on the CPU: ``BENCHMARK.json``'s names and
shape, every piece found by name, the result line's keys, and no JAX."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests.cells import TINY

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == allowed, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                        and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name, chips, config", [
    ("base_train_dp4", 4, "siammask_base_bf16"),
    ("sharp_vot_1obj", 1, "siammask_sharp_bf16")])
def test_a_cell_of_its_traffic_file_alone(name, chips, config):
    """The four-card cell and the per-frame VOT cell are defined by their
    traffic files and not in BENCHMARK.json: found, with set-up as their
    only end-to-end metric and no per-layer metric."""
    assert name not in {w["name"] for w in BENCH["workloads"]}
    found = harness.find_cell(name)
    assert found["cell"]["chips"] == chips and found["config"]["name"] == config
    assert [m["name"] for m in found["end_to_end"]] == ["setup_s"]
    assert found["per_layer"] == []


def test_every_piece_found_by_name():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.metric_reader(m["name"]))
        layers.setdefault(m["layer"], m["layer"])
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", list(cells))
            assert w in cells and w in reports, (m["name"], w)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in cells.values())
    for name, w in cells.items():
        found = harness.find_cell(name)
        assert found["config"]["name"] == w["config"]
        assert harness.driver(found["traffic"]).setup
        reported = {m["name"] for m in found["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert found["per_layer"], name
        assert w["chips"] in (1, 4)


def test_result_line_keys(tiny_vot):
    assert list(tiny_vot) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(tiny_vot["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in tiny_vot["checks"].values():
        assert set(check) == {"value", "limit"}


def test_runs_without_jax():
    """A whole CPU run of a cell in a fresh interpreter loads no JAX module
    nor the JAX package (by top-level name: the port's begins with it)."""
    code = (
        "import json\n"
        "from perfbench import harness\n"
        "out = harness.run_cell('sharp_vos_16obj', 7, 0.5, False, device='cpu',"
        " require_card=False, overrides={'config': {'width': 8, 'dtype': 'float32'},"
        " 'traffic': {'objects': 2, 'chunk': 2, 'pool_frames': 3, 'check_frames': 2}})\n"
        "import sys\n"
        "print(json.dumps({'forbidden': harness.forbidden_modules(),"
        " 'port': 'siammask_tpu_torch' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == {"forbidden": [], "port": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siammask_tpu_torch_x", sys)
    assert "siammask_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "siammask_tpu", sys)
    assert "siammask_tpu" in harness.forbidden_modules()


def test_refuses_without_a_card(tmp_path):
    """Without a visible card the command exits non-zero and prints no
    result (CUDA_VISIBLE_DEVICES empties the card list)."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sharp_vos_16obj",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sharp_vos_16obj",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture(scope="module")
def tiny_vot():
    return harness.run_cell("sharp_vot_1obj", 2 ** 31 + 11, 0.5, False, device="cpu",
                            require_card=False, overrides=TINY["sharp_vot_1obj"])
