"""The entry point refuses to run where it cannot measure: no CUDA card
(this sandbox), or a checkout that holds only the benchmark."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "box-ramp", "--seed", str(2**31 + 5), "--seconds",
        "1", "--trace", "0"]


def _run(root: Path):
    return subprocess.run([sys.executable, str(root / "perfbench/run.py"),
                           *ARGS], capture_output=True, text=True,
                          timeout=300, cwd=root)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
