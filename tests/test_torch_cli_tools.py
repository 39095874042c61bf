"""The port's ``visualize``, ``profile`` and ``analyze_convergence`` CLIs
(``--device cpu``) on ``test_torch_cli.py``'s synthetic project, trained 2
epochs by the port's train CLI, against the JAX package's.

``visualize``: with ``SOURCE_DATE_EPOCH`` set, each subcommand's PDF is
byte-identical to the JAX script's (``scripts/visualize.py``, loaded from
its file) on the same project: the carve, the loss history, the
evaluation's renders, the exported Gaussians and the body ellipses are
the same data in both. ``profile``: the report's keys are the JAX
``profile_model``'s (``test_torch_profiling.py`` holds the two key lists
equal) and its image, grid and Gaussian count those of the JAX script's
model on the same arguments, every time positive; the timing loop runs
each stage once here (``time_fn`` patched to no warm-up and one
iteration: the synthetic model renders 16000 Gaussians in ``"tiled"``
mode, seconds a call on the CPU). ``analyze_convergence``: the summary
and the plot's bytes equal the JAX functions' on the same two logs.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.utils import profiling as tprof
from test_torch_cli import jax_model, run_cli, train_project

pytest.importorskip("h5py")
pytest.importorskip("matplotlib")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["image", "grid", "max_gaussians", "carve_ms", "unet_ms", "extract_ms",
        "render_fwd_ms", "full_fwd_ms", "full_fwd_bwd_ms", "render_mpix_s",
        "train_step_s", "train_steps_per_s"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fixed_pdf_date(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_tools")
    cfg, log = train_project(root)
    run_cli("evaluate", cfg)
    npz, _ = run_cli("export_gaussians", cfg, "--frame", "3")
    (root / "3d.log").write_text(log)
    return dict(cfg=cfg, root=root, npz=npz[0], log=str(root / "3d.log"))


@pytest.mark.parametrize("cmd", ["gaussians", "voxels", "training", "renders",
                                 "ellipses"])
def test_visualize_matches_jax_script(project, cmd, tmp_path):
    import argparse

    cfg = project["cfg"]
    args = {"gaussians": [project["npz"], "--output", str(tmp_path / "g.pdf")],
            "voxels": [cfg, "--frame", "5"], "training": [cfg],
            "renders": [cfg, "--num", "2"], "ellipses": [cfg, "--num", "9"]}[cmd]
    out, _ = run_cli("visualize", cmd, *args)
    got = open(out, "rb").read()
    assert got.startswith(b"%PDF") and len(got) > 2000
    ns = argparse.Namespace(path=project["npz"], output=str(tmp_path / "j.pdf"),
                            config=cfg, frame=5,
                            num={"renders": 2, "ellipses": 9}.get(cmd))
    getattr(_jax_script("visualize"), f"cmd_{cmd}")(ns)
    ref_fn = ns.output if cmd == "gaussians" else out
    assert got == open(ref_fn, "rb").read()


@pytest.fixture
def one_pass_timing(monkeypatch):
    """Each stage timed once, without a warm-up."""
    time_fn = tprof.time_fn
    monkeypatch.setattr(tprof, "time_fn", lambda fn, *a, iters=20, warmup=2,
                        **k: time_fn(fn, *a, iters=1, warmup=0, **k))


@pytest.mark.parametrize("how", ["synthetic", "config"])
def test_profile(project, one_pass_timing, tmp_path, how, capsys):
    from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel

    if how == "synthetic":
        args = ["synthetic", "--grid", "32", "--width", "16", "--height", "16",
                "--mode", "2d"]
        jm = JModel(np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
                    np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)), 16, 16,
                    ell=0.3, grid_size=32, volume_idx=[[0, 32]] * 3,
                    gaussian_mode="2d")
    else:
        args = ["config", project["cfg"], "--frame", "4"]
        _, jm, _ = jax_model(project["cfg"])
    report, out = run_cli("profile", *args, "--trace", str(tmp_path / "tr"))
    assert list(report) == KEYS
    assert json.loads(out) == {k: (round(v, 3) if isinstance(v, float) else v)
                               for k, v in report.items()}
    assert report["image"] == f"{jm.W}x{jm.H}"
    assert report["grid"] == list(jm.input_size)
    assert report["max_gaussians"] == jm.max_n
    assert all(report[k] > 0 for k in KEYS[3:])
    assert len(list((tmp_path / "tr").glob("*.pt.trace.json"))) == 1
    assert "trace written" in capsys.readouterr().err


def test_analyze_convergence_matches_jax(project, tmp_path):
    from pose_splatter_tpu.utils import loganalysis as jla

    cfg2d, log2d = train_project(tmp_path / "p2d", gaussian_mode="2d")
    (tmp_path / "2d.log").write_text(log2d)
    logs = (str(tmp_path / "2d.log"), project["log"])
    summary, out = run_cli("analyze_convergence", "--log2d", logs[0],
                           "--log3d", logs[1], "--plot",
                           str(tmp_path / "t.pdf"), "--out",
                           str(tmp_path / "s.json"))
    d2, d3 = (jla.parse_training_log(p) for p in logs)
    ref = jla.convergence_summary(d2, d3)
    assert summary == ref == json.loads((tmp_path / "s.json").read_text())
    assert json.loads(out) == ref and len(d2["epochs"]) == 2
    jla.plot_convergence_comparison(d2, d3, str(tmp_path / "j.pdf"))
    assert (tmp_path / "t.pdf").read_bytes() == (tmp_path / "j.pdf").read_bytes()
