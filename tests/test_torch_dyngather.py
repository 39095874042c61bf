"""The port's dynamic-gather function against the JAX package's Pallas
probe kernel (``scripts/dbg_dyngather_micro.py::_run_kernel``, run in
interpret mode), bit for bit, and the port's probe script and wrapper
checks, on the CPU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_torch.ops import dyngather as D
from pose_splatter_torch.scripts import dbg_dyngather_micro as probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
S, L = 64, 128


@pytest.fixture(scope="module")
def jscript():
    """The JAX probe script, loaded from its file as it stands."""
    spec = importlib.util.spec_from_file_location(
        "jax_dbg_dyngather_micro", ROOT / "scripts" / "dbg_dyngather_micro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _indices(rng, axis, pattern, reps):
    hi = (S if axis == 0 else L) - (reps > 1)
    if pattern == "rowbcast":
        return rng.integers(0, hi, (S, 1)).repeat(L, 1).astype(np.int32)
    return rng.integers(0, hi, (S, L)).astype(np.int32)


@pytest.mark.parametrize("axis,reps,pattern", [
    (0, 1, "random"), (0, 4, "random"), (0, 4, "rowbcast"),
    (1, 1, "random"), (1, 4, "random"), (0, 1, "rowbcast")])
def test_gather_sum_equals_the_pallas_kernel(jscript, axis, reps, pattern):
    """Sequential float32 sums in r on both sides: equal, not close."""
    rng = np.random.default_rng(10 * axis + reps)
    tab = rng.normal(size=(S, L)).astype(np.float32)
    idx = _indices(rng, axis, pattern, reps)
    run = jscript._run_kernel(axis, jnp.asarray(tab), jnp.asarray(idx), reps)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run(jnp.asarray(tab), jnp.asarray(idx)))
    got = D.gather_sum(torch.from_numpy(tab), torch.from_numpy(idx), axis, reps)
    np.testing.assert_array_equal(ref, got.numpy())
    if reps == 1:
        one = D.gather(torch.from_numpy(tab), torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(ref, one.numpy())
    assert D.gather_sum.launches == D.gather.launches == 0  # no kernel here


def test_probe_correct_on_the_cpu(capsys):
    """The probe's correctness check at the image-table shape [2304, 128]."""
    assert probe.probe_correct(device="cpu", seed=3) == {0: True, 1: True}
    out = capsys.readouterr().out
    assert "axis=0 correctness: OK" in out and "axis=1 correctness: OK" in out


def test_probe_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """An index off the table raises, as torch.take_along_dim does; with
    reps > 1 the offset 1 must stay inside too. Nothing is clamped."""
    tab = torch.zeros((S, L))
    idx = torch.zeros((S, L), dtype=torch.int32)
    for axis, dim in ((0, S), (1, L)):
        edge = idx.clone()
        edge[5, 7] = dim - 1
        D.gather(tab, edge, axis)  # the last row / lane, offset 0: fine
        with pytest.raises(IndexError):
            D.gather_sum(tab, edge, axis, 2)
        neg = idx.clone()
        neg[2, 3] = -1
        with pytest.raises(IndexError):
            D.gather(tab, neg, axis)
        with pytest.raises(IndexError):
            D.gather(tab, edge + 1, axis)
    bad = [
        (tab.double(), idx, 0, 1, TypeError),
        (tab, idx.long(), 0, 1, TypeError),
        (tab[:-1], idx, 0, 1, ValueError),
        (tab.t(), idx.t(), 0, 1, ValueError),  # not contiguous
        (tab, idx, 2, 1, ValueError),
        (tab, idx, 0, 0, ValueError),
    ]
    for t, i, axis, reps, err in bad:
        with pytest.raises(err):
            D.gather_sum(t, i, axis, reps)


@pytest.mark.parametrize("shape", [(0, 128), (2304, 0)])
def test_launch_on_an_empty_table_launches_nothing(shape):
    """``launch`` returns "none" before it builds or calls the kernel, and
    counts nothing."""
    tab = torch.zeros(shape)
    idx = torch.zeros(shape, dtype=torch.int32)
    before = D.gather.launches
    assert D.launch(D.gather, tab, idx, torch.empty_like(tab), 0, 1) == "none"
    assert D.gather.launches == before
