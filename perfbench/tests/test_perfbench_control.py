"""On the card: the control of each cell's comparison comes out not
correct, and the program within the limits, at the cell's own size (a
short window). The benchmark's own runs never run the control. Run on a
GPU host::

    PYTHONPATH=src python3 -m pytest --noconftest -m cuda -q \\
        perfbench/tests/test_perfbench_control.py
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels, which have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda):
    from perfbench import control
    r = control.readings(cell, 2 ** 31 + 5, 10.0, cuda)
    assert r["program"]["correct"] is True, r
    assert r["control"]["correct"] is False, r
