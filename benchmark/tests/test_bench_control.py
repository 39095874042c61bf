"""The control of ``correct`` on the card, at a size a test run holds: the
reference computed with TF32 on (the precision just below the float32
that the configurations state), put in the program's place, has to read
far above the program itself on at least one number of each cell.

Run on the card with ``python3 -m pytest benchmark/tests -m cuda``; the
same comparison at the cells' own sizes is ``python3 -m
benchmark.calibrate``."""

import pytest
import torch

from benchmark import calibrate

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("like", ["train-2d", "render-2d", "render-3d", "train-3d"])
def test_tf32_control_fails(tiny, like):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card has")
    cell = tiny(like, poses=8, sample_share=1.0)
    for seed in SEEDS:
        row = calibrate.readings(cell, seed, 0.5, "cuda:0")
        ratios = [row["control"][k] / max(v, 1e-12)
                  for k, v in row["program"].items()]
        assert max(ratios) >= 10.0, row
