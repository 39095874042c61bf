"""The port's parallel package on one process and in short-lived ranks:
``process_local_indices`` and ``_padded_origins`` against the JAX
functions, the mesh and collectives without a process group, the device
and backend rules, the launcher's faults, and the scripts' flags against
the JAX scripts' (``scripts/scaling.py``, ``scripts/dbg_highres_sharded.py``)."""

import argparse
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pose_splatter_tpu.parallel.multihost import (
    process_local_indices as jprocess_local_indices,
)
from pose_splatter_tpu.parallel.tile_sharding import (
    _padded_origins as jpadded_origins,
)
from pose_splatter_torch.parallel import (
    initialize_distributed,
    make_mesh,
    process_local_indices,
)
from pose_splatter_torch.parallel import comm
from pose_splatter_torch.parallel.launch import LaunchError, launch
from pose_splatter_torch.parallel.multihost import process_group
from pose_splatter_torch.parallel.tile_sharding import _padded_origins

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(0, 40), batch=st.integers(1, 12),
       count=st.integers(1, 6), seed=st.integers(0, 1000))
def test_process_local_indices_equals_jax(n, batch, count, seed):
    order = np.random.default_rng(seed).permutation(n)
    for p in range(count):
        try:
            want = jprocess_local_indices(order, batch, p, count)
        except ValueError:
            with pytest.raises(ValueError):
                process_local_indices(order, batch, p, count)
            continue
        np.testing.assert_array_equal(
            process_local_indices(order, batch, p, count), want)


def test_process_local_indices_partition():
    """``tests/test_multihost.py:68-82`` on the port: the defaults are this
    process (0 of 1) without a process group."""
    order = np.random.default_rng(0).permutation(24)
    parts = [process_local_indices(order, batch_size=8, process_index=p,
                                   process_count=4)
             for p in range(4)]
    assert sorted(np.concatenate(parts).tolist()) == sorted(order.tolist())
    w0 = np.concatenate([p[:2] for p in parts])
    assert sorted(w0.tolist()) == sorted(order[:8].tolist())
    with pytest.raises(ValueError):
        process_local_indices(order, batch_size=6, process_index=0,
                              process_count=4)
    np.testing.assert_array_equal(process_local_indices(order, 8), order)


@pytest.mark.parametrize("row_aligned", [False, True])
@pytest.mark.parametrize("hw,tile,n_dev", [
    ((72, 64), (8, 64), 8), ((72, 64), (8, 64), 4), ((40, 64), (8, 64), 2),
    ((32, 64), (8, 32), 4), ((512, 576), (8, 128), 4), ((1024, 1152), (32, 128), 3),
])
def test_padded_origins_equal_jax(hw, tile, n_dev, row_aligned):
    want = jpadded_origins(*hw, tile, n_dev, row_aligned=row_aligned)
    got = _padded_origins(*hw, tile, n_dev, row_aligned=row_aligned)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    assert tuple(got[1:]) == tuple(int(x) for x in want[1:])
    assert got[0].shape[0] % n_dev == 0


def test_mesh_without_a_group_is_the_identity():
    """No process group: a mesh of one rank keeps its axis names and
    shape, and every collective is the identity (a ppermute by a hop
    receives zeros: no rank sends)."""
    mesh = make_mesh((1, 1), ("data", "tile"))
    assert mesh.axis_names == ("data", "tile")
    assert mesh.shape == {"data": 1, "tile": 1}
    assert mesh.coords == {"data": 0, "tile": 0}
    assert mesh.group("tile") is None
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = (comm.psum(x, mesh, "tile") + comm.pmean(x, mesh, "data")
         + comm.replicated(x, mesh, "tile")
         + comm.gather_strips(x, mesh, "tile", 1))
    y.sum().backward()
    torch.testing.assert_close(y, 4 * x.detach())
    torch.testing.assert_close(x.grad, torch.full((2, 3), 4.0))
    assert comm.ppermute(x, mesh, "tile", 1).abs().sum() == 0
    (m,) = comm.mean_over([x.detach()], mesh, "data")
    torch.testing.assert_close(m, x.detach())
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",))
    with pytest.raises(KeyError):
        mesh.group("model")


def test_single_process_initialises_nothing(monkeypatch):
    """As the JAX function: one process and no coordinator is a no-op."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_cuda_without_a_gpu_raises():
    """No fallback: asking for the card without one raises, before any
    group forms."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("127.0.0.1:1", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with process_group("cuda"):
            pass
    assert not torch.distributed.is_initialized()


def test_a_dying_rank_fails_the_launch():
    """Rank 1 exits with an error while rank 0 would wait for ever: the
    launcher stops rank 0 and raises within seconds."""
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(LaunchError, match="rank 1 exited with 3") as err:
        launch(2, ["-c", code], timeout=100)
    assert time.monotonic() - t0 < 60
    assert [r.returncode for r in err.value.results][1] == 3
    assert err.value.results[0].returncode != 0


def test_ranks_past_the_time_limit_fail():
    with pytest.raises(LaunchError, match="outlived"):
        launch(1, ["-c", "import time; time.sleep(120)"], timeout=1)


def test_a_group_that_does_not_form_raises():
    """Rank 1 never joins: rank 0's ``initialize_distributed`` raises when
    its timeout runs out (no hang, no single-rank run instead)."""
    code = ("import os, sys\n"
            "if os.environ['RANK'] == '1':\n"
            "    import time; time.sleep(60)\n"
            "from pose_splatter_torch.parallel import initialize_distributed\n"
            "initialize_distributed(device='cpu', timeout=3)\n")
    with pytest.raises(LaunchError, match="rank 0 exited"):
        launch(2, ["-c", code], timeout=100)


def _jax_parser(path):
    """The argparse parser a JAX script builds in its ``main`` (stopped
    at ``parse_args``, before anything imports jax)."""
    spec = importlib.util.spec_from_file_location("_jax_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Caught(Exception):
        pass

    def grab(self, *a, **k):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        mod.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the script built no parser")


def _options(parser):
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_scaling_flags_match_jax():
    from pose_splatter_torch.scripts import scaling

    jax_opts = _options(_jax_parser(ROOT / "scripts" / "scaling.py"))
    port_opts = _options(scaling.build_parser())
    assert set(port_opts) == set(jax_opts) | {"--device"}
    assert {k: port_opts[k] for k in jax_opts} == jax_opts
    assert port_opts["--device"] == "cuda"


def test_highres_probe_flags_and_defaults():
    """The JAX probe's three flags with its defaults; the size flags
    default to its fixed shape (``dbg_highres_sharded.py:55-77``)."""
    from pose_splatter_torch.scripts import dbg_highres_sharded as hr

    jax_opts = _options(_jax_parser(ROOT / "scripts" / "dbg_highres_sharded.py"))
    port = hr.build_parser()
    port_opts = _options(port)
    assert {k: port_opts[k] for k in jax_opts} == jax_opts
    assert hr.C == 6
    assert (port_opts["--width"], port_opts["--height"],
            port_opts["--grid"]) == (1152, 1024, 256)
    assert port_opts["--crop"] == "0,192,32,192,50,178"
    assert (port_opts["--tile"], port_opts["--capacity"]) == ("32,128", 4096)
    assert (port_opts["--min-n"], port_opts["--max-n"],
            port_opts["--carve-cap"]) == (1024, 16000, 262144)
    args = port.parse_args(["--devices", "2", "--device", "cpu", "--steps", "3"])
    assert (args.devices, args.device, args.steps) == (2, "cpu", 3)
