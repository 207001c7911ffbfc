"""The import guard compares whole top-level module names."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]


def test_guard_compares_top_level_names_whole():
    names = ["waiwera_tpu_torch", "waiwera_tpu_torch.sim", "jaxtyping",
             "flaxen", "torch", "perfbench.reference.frozen"]
    assert harness.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "waiwera_tpu", "waiwera_tpu.ops.dia"]
    assert harness.forbidden_modules(names + bad) == sorted(bad)


@pytest.mark.parametrize("name", ["waiwera_tpu", "jax", "jaxlib", "flax"])
def test_guard_raises_naming_the_module(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(harness.SetupError, match=name):
        harness.guard("in a test")


def test_port_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import waiwera_tpu_torch.sim.simulation,"
            " waiwera_tpu_torch.sim.timestepper, waiwera_tpu_torch.sim.output;"
            "import perfbench.reference.check, perfbench.lib.harness as h;"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    """The reference and the check load neither the port nor JAX."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.reference.check, perfbench.reference.flow;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'waiwera_tpu_torch', 'waiwera_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
