"""The benchmark on the card: a short run of each cell is correct, and its
control (the reference computed in float8, one precision below the bf16
the configurations state, in the system's place) is not. Skipped without
a card.

    python -m pytest portbench/tests -q -m cuda
"""

import time

import pytest

from pbcore import harness, manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(name: str, seed: int, control=None):
    return harness.run_cell(manifest.cell(name), seed, 5.0, False, "cuda", time.perf_counter(),
                            control=control, log=lambda m: None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    res = _run(name, 2 ** 31 + 17)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(card, name):
    res = _run(name, 2 ** 31 + 18, control="fp8")
    assert not res["correct"], res["checks"]
