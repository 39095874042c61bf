"""The port's utility scripts and shell wrappers
(``pose_splatter_torch/scripts/{doctor,dataset_utils,organize_export,
estimate_up_direction}.py`` and ``run_*.sh``) against the JAX scripts
(``scripts/``, loaded from their files), on the CPU.

- ``doctor --device cpu`` exits 0.
- ``dataset_utils`` ``verify`` / ``compare`` / ``update_paths`` /
  ``analyze`` print what the JAX script prints, and write the same file.
- ``organize_export`` copies the same files and writes the same manifest,
  timestamp aside.
- ``estimate_up_direction``, its clicks (``collect_lines``) replaced by
  fixed lines, writes the JAX script's ``vertical_lines.npz``.
- Every ``python -m`` line of the ``.sh`` wrappers names a module (and a
  subcommand) that exists, each JAX wrapper's commands have their
  counterparts, and ``run_training.sh <config> ... --device cpu`` trains
  one batch.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.scripts import dataset_utils as tdu
from pose_splatter_torch.scripts import doctor
from pose_splatter_torch.scripts import estimate_up_direction as tup
from pose_splatter_torch.scripts import organize_export as toe
from pose_splatter_torch.scripts import preprocess as tpre
from test_torch_cli import make_project

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SH = ["run_training.sh", "run_evaluation.sh", "run_full_preprocessing.sh",
      "run_full_pipeline.sh", "run_2d_3d_comparison.sh"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, argv=None, monkeypatch=None, jax_argv=None):
    """Run ``fn`` (a port ``main(argv)`` or, with ``jax_argv``, a JAX
    ``main()`` reading ``sys.argv``); returns (exit code, stdout)."""
    out = io.StringIO()
    code = 0
    if jax_argv is not None:
        monkeypatch.setattr(sys, "argv", ["script.py", *jax_argv])
    with contextlib.redirect_stdout(out):
        try:
            fn() if argv is None else fn(argv)
        except SystemExit as e:
            code = e.code or 0
    return code, out.getvalue()


@pytest.fixture
def project(tmp_path):
    return make_project(tmp_path, "2d")


def test_doctor_on_the_cpu_exits_0(capsys):
    with pytest.raises(SystemExit) as e:
        doctor.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "[OK  ] core imports" in out
    assert "[OK  ] rasterizer smoke test: fwd+bwd rasterize through the " \
           "plain versions (cpu)" in out
    for src in (ROOT / "pose_splatter_torch" / "csrc").glob("*.cu"):
        assert f"kernel {src.name}" in out


@pytest.mark.parametrize("stores,loads", [(0, 0), (8, 0), (0, 4)])
def test_doctor_fails_a_kernel_that_spills(tmp_path, stores, loads):
    """``spills`` reads a ``ptxas -v`` log's spill line, and the kernel
    check passes the library whose log reports none and fails one whose
    log reports a spill store or load."""
    from concurrent.futures import Future

    line = (f"    0 bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads")
    log = "ptxas info    : Function properties for fwd_sum\n" + line + "\n"
    assert doctor.spills(log) == ([] if stores == loads == 0 else [line.strip()])
    lib = tmp_path / "libfwd.so"
    lib.write_bytes(b"")
    (tmp_path / "libfwd.so.log").write_text(log)
    built = Future()
    built.set_result(lib)
    assert doctor.check("kernel fwd.cu", doctor.kernel("fwd", built)) \
        == (stores == loads == 0)


def test_doctor_fails_a_kernel_without_its_build_log(tmp_path, capsys):
    """A library whose ``ptxas`` log is missing fails the kernel check
    instead of passing it unread."""
    from concurrent.futures import Future

    lib = tmp_path / "libfwd.so"
    lib.write_bytes(b"")
    built = Future()
    built.set_result(lib)
    assert not doctor.check("kernel fwd.cu", doctor.kernel("fwd", built))
    assert "libfwd.so.log is missing" in capsys.readouterr().out


def test_dataset_utils_match_the_jax_script(project, tmp_path, monkeypatch):
    jdu = _load("dataset_utils")
    with open(project) as f:
        cfg = json.load(f)
    # verify: a passing project, then one whose images.h5 is missing.
    for expect in (0, 1):
        ref = _run(jdu.main, monkeypatch=monkeypatch,
                   jax_argv=["verify", project])
        got = _run(tdu.main, ["verify", project, "--device", "cpu"])
        assert got == ref and ref[0] == expect, (ref, got)
        if expect == 0:
            os.rename(Path(cfg["project_directory"]) / "images" / "images.h5",
                      tmp_path / "moved.h5")
    # compare: two configs that differ in two keys and one missing key.
    other = tmp_path / "other.json"
    other.write_text(json.dumps(dict(cfg, lr=5e-4, grid_size=32,
                                     extra_key=1)))
    ref = _run(jdu.main, monkeypatch=monkeypatch,
               jax_argv=["compare", project, str(other)])
    got = _run(tdu.main, ["compare", project, str(other)])
    assert got == ref and "grid_size:" in ref[1] and "<missing>" in ref[1]
    # update_paths: the same file written.
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    shutil.copy(project, a)
    shutil.copy(project, b)
    flags = ["--data_directory", "/data/x", "--project_directory", "/proj/y"]
    ref = _run(jdu.main, monkeypatch=monkeypatch,
               jax_argv=["update_paths", str(a), *flags])
    got = _run(tdu.main, ["update_paths", str(b), *flags])
    assert got[1].replace(str(b), str(a)) == ref[1]
    assert a.read_text() == b.read_text()
    assert json.loads(b.read_text())["project_directory"] == "/proj/y"
    # analyze: no metadata, then a training history.
    ref = _run(jdu.main, monkeypatch=monkeypatch, jax_argv=["analyze", project])
    got = _run(tdu.main, ["analyze", project])
    assert got == ref and ref[0] == 1
    meta = Path(cfg["project_directory"]) / "checkpoint.ckpt.meta.json"
    meta.write_text(json.dumps(dict(
        losses=[[0.5, 0.3, 0.2], [0.4, 0.25, 0.15], [0.42, 0.2, 0.1]],
        validation_losses=[0.9, 0.7, 0.8])))
    ref = _run(jdu.main, monkeypatch=monkeypatch, jax_argv=["analyze", project])
    got = _run(tdu.main, ["analyze", project, "--device", "cpu"])
    assert got == ref and "Epochs trained: 3" in ref[1]


def test_organize_export_matches_the_jax_script(project, monkeypatch):
    joe = _load("organize_export")
    assert toe.CANDIDATES == joe.CANDIDATES
    proj = Path(json.loads(Path(project).read_text())["project_directory"])
    rng = np.random.default_rng(0)
    (proj / "metrics_test.csv").write_text("camera,psnr\n0,30.1\n")
    (proj / "loss.pdf").write_bytes(rng.bytes(300))
    np.save(proj / "features.npy", rng.normal(size=(4, 3)))
    (proj / "checkpoint.ckpt.meta.json").write_text('{"losses": [[1, 2, 3]]}')
    ref = _run(joe.main, monkeypatch=monkeypatch,
               jax_argv=[project, "--name", "jax"])
    got = _run(toe.main, [project, "--name", "torch", "--device", "cpu"])
    assert ref[0] == got[0] == 0
    (jdir,) = (proj / "exports").glob("*_jax")
    (tdir,) = (proj / "exports").glob("*_torch")
    jman = json.loads((jdir / "manifest.json").read_text())
    tman = json.loads((tdir / "manifest.json").read_text())
    assert jman.pop("timestamp") and tman.pop("timestamp")
    assert tman == jman
    assert jman["files"] == ["config.json", "metrics_test.csv", "loss.pdf",
                             "features.npy", "checkpoint_meta.json"]
    assert (sorted(p.name for p in tdir.iterdir())
            == sorted(p.name for p in jdir.iterdir()))
    for name in jman["files"]:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    assert got[1].split("(")[-1] == ref[1].split("(")[-1]


def test_estimate_up_direction_writes_the_jax_file(tmp_path, monkeypatch):
    from test_torch_preprocess import make_video_project

    jup = _load("estimate_up_direction")
    _, make = make_video_project(tmp_path, n_cams=4, T=2)

    def clicks(imgs):
        """Two near-vertical lines a view, in the first frame's pixels."""
        assert len(imgs) == 4 and imgs[0].ndim == 3
        return [[((10.0 + c, 5.0), (12.0 + c, 40.0)),
                 ((30.0, 8.0 + c), (29.0, 44.0))] for c in range(4)]

    written = []
    for mod, name in ((jup, "jax"), (tup, "torch")):
        cfg = make(name)
        monkeypatch.setattr(mod, "collect_lines", clicks)
        if mod is jup:
            code, out = _run(jup.main, monkeypatch=monkeypatch,
                             jax_argv=[cfg])
        else:
            code, out = _run(tup.main, [cfg, "--device", "cpu"])
        assert code == 0 and "Estimated up direction" in out
        with open(cfg) as f:
            c = json.load(f)
        written.append(Path(c["project_directory"]) / c["vertical_lines_fn"])
    ref, got = (np.load(p, allow_pickle=True) for p in written)
    assert ref.files == got.files
    for k in ref.files:
        np.testing.assert_array_equal(ref[k], got[k])
    assert abs(np.linalg.norm(got["up"]) - 1.0) < 1e-6


def _modules(text):
    """(module, subcommand or None) of every ``python -m`` line of a
    wrapper; the preprocessing steps go through ``$PRE <subcommand>``."""
    found = [(m, None) for m in re.findall(
        r"-m pose_splatter_torch\.scripts\.(\w+)", text)]
    found += [("preprocess", s) for s in re.findall(r"\$PRE (\w+)", text)]
    return found


@pytest.mark.parametrize("name", SH)
def test_wrapper_commands_exist(name):
    """Every module and subcommand a wrapper calls exists, takes
    ``--device``, and the JAX wrapper's scripts all have a counterpart."""
    text = (ROOT / "pose_splatter_torch" / "scripts" / name).read_text()
    calls = _modules(text)
    assert calls
    choices = tpre.build_parser()._subparsers._group_actions[0].choices
    for mod, sub in calls:
        spec = importlib.util.find_spec(f"pose_splatter_torch.scripts.{mod}")
        assert spec is not None, mod
        if sub is not None:
            assert sub in choices, sub
            assert any("--device" in a.option_strings
                       for a in choices[sub]._actions)
    jtext = "\n".join(
        ln for ln in (ROOT / "scripts" / name).read_text().splitlines()
        if not ln.lstrip().startswith("#"))
    jcalls = set(re.findall(r"python scripts/(\w+)\.py(?: (\w+))?", jtext))
    jcalls = {(m, s if m == "preprocess" else None) for m, s in jcalls}
    port = {(m, s if m == "preprocess" else None) for m, s in calls}
    assert jcalls <= port, jcalls - port
    for wrapper in re.findall(r"bash scripts/(\w+\.sh)", jtext):
        assert f'"$HERE/{wrapper}"' in text, wrapper
    assert re.search(r'"\$@"', text), "extra arguments must pass through"


def test_run_training_trains_one_batch(project):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["bash", str(ROOT / "pose_splatter_torch" / "scripts"
                     / "run_training.sh"), project, "--epochs", "1",
         "--max_batches", "1", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proj = Path(json.loads(Path(project).read_text())["project_directory"])
    log = (proj / "logs" / "training.log").read_text()
    assert "epoch 1" in log, log
    assert (proj / "checkpoint.ckpt.meta.json").exists()
    meta = json.loads((proj / "checkpoint.ckpt.meta.json").read_text())
    assert meta["epoch"] == 1 and len(meta["losses"]) == 1
