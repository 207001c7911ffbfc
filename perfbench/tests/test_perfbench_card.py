"""The check that decides `correct` on the card at a test size: a sound
run passes and the control fails. Skips without a CUDA card."""

import time
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
def test_sound_and_control_on_card(card):
    runs = [harness.run_cell(ROOT, "box-ramp", 2**31 + 99, 3.0, False,
                             time.perf_counter(), device=card,
                             grid=(16, 8, 8), control=control,
                             episode_steps=3, log=lambda *a, **k: None)
            for control in (False, True)]
    (sound, _), (ctrl, checks) = runs
    assert sound["correct"]
    assert not ctrl["correct"], checks
