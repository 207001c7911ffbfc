"""BENCHMARK.json against the contract it is written to, and the rule
that every cell, configuration and metric is a file found by its name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    for w in manifest["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in manifest["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        got = [x["name"] for x in manifest[group]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for text in ([w["why"] for w in manifest["workloads"]]
                 + [c["source"] for c in manifest["configs"]]
                 + [m["layer"] for m in manifest["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_exists(manifest):
    bench = ROOT / "perfbench"
    for c in manifest["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for w in manifest["workloads"]:
        assert (bench / "workloads" / f"{w['name']}.json").is_file()
        assert (bench / "configs" / f"{w['config']}.py").is_file()
        assert w["chips"] == 1
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def _reports(manifest, metric, cell):
    return cell in metric.get("workloads", [w["name"]
                                            for w in manifest["workloads"]])


def test_moves_reported_where_read(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for w in manifest["workloads"]:
            if _reports(manifest, m, w["name"]):
                assert _reports(manifest, e2e[m["moves"]], w["name"]), \
                    (m["name"], w["name"])
    for w in manifest["workloads"]:
        got = [m["name"] for m in manifest["end_to_end"]
               if _reports(manifest, m, w["name"])]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reports(manifest, m, w["name"])
                   for m in manifest["per_layer"])


def test_added_cell_needs_no_edit(tmp_path, manifest):
    """A new cell is a new workload file and a new BENCHMARK.json entry:
    the harness finds its episode, configuration and metrics by name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    wl = json.loads((tmp_path / "perfbench/workloads/box-ramp.json")
                    .read_text())
    wl["episode"]["size"] = 8000.0
    (tmp_path / "perfbench/workloads/box-slow.json").write_text(
        json.dumps(wl))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "box-slow", "config": "box-wge-524k",
                           "traffic": "box-slow", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data
    man = harness.load_manifest(tmp_path)
    entry = harness.cell_entry(man, "box-slow")
    bench = tmp_path / "perfbench"
    got = harness.load_workload("box-slow", bench)
    cfg = harness.config_module(entry["config"], bench)
    model = harness.model_for(got, cfg, 5, grid=(3, 2, 2))
    assert model["time"]["step"]["size"] == 8000.0
    assert model["time"]["step"]["solver"]["linear"]["dtype"] == "float32"
    for metric in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.metric_reader(metric["name"], bench).read)
