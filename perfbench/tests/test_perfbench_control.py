"""The control comes out not correct: the reference one step below the
configuration's precision, put in the program's place, fails one of the
cell's limits that the program's own run keeps.  On the CPU at the tiny
size (its int4 GPT trunk; the CPU has no TF32), and on the card at a
cell's own size (`perfbench/control.py`)."""

import json

import pytest

from helpers import TINY_LIMITS, make_root


def _fails(numbers: dict, limits: dict) -> list:
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


def test_control_fails_a_limit_tiny(tmp_path):
    import time

    from perfbench.control import one_seed

    out = one_seed("tiny.cell", 31, 2.0, time.monotonic(), "cpu", make_root(tmp_path))
    assert not _fails(out["program"], TINY_LIMITS), out["program"]
    assert "latent_err" in _fails(out["control"], TINY_LIMITS), out["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["beam3.single", "sample.poisson"])
def test_control_fails_a_limit_on_the_card(cell):
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its own size on the card")
    from perfbench.control import one_seed
    from perfbench.registry import Registry

    reg = Registry()
    limits = reg.limits(reg.cell(cell)["config"])
    out = one_seed(cell, 2 ** 31 + 77, 9.0, time.monotonic())
    print(json.dumps(out))
    assert not _fails(out["program"], limits), out["program"]
    assert _fails(out["control"], limits), out["control"]
