"""The port's temporal benchmark
(``pose_splatter_torch/scripts/temporal_benchmark.py``) against the JAX
script (``scripts/temporal_benchmark.py``, loaded from its file), on the
CPU at a small size: 3 cameras of 32×32, grid 16, 2 unique poses, a
sequence of 4 frames, the same seeded weights in both packages (through the
bridge). The JAX script renders with its Pallas kernels in interpret mode.

- The report has the JAX script's keys plus ``decode``; held-out PSNR
  within 1e-3 dB, SSIM within 1e-4, IoU equal.
- ``--end-to-end --keep-frames`` writes ``length`` PNGs. Their pixels equal
  the default mode's uint8 renders, and they sit within one level of the
  JAX script's PNGs (XLA may fuse ``rgb·255 + 0.5`` into one rounding).
- ``run_sequence`` renders each frame once, in order, fetches it one frame
  behind and finishes every write.
- The default device is the card.
"""

import ast
import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.scripts import synthetic_benchmark as tsb
from pose_splatter_torch.scripts import temporal_benchmark as ttb
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
C, H, W, T, GRID, LENGTH = 3, 32, 32, 2, 16, 4
SCENE = dict(cameras=C, width=W, height=H, grid=GRID, mode="2d", frames=T,
             crop=None, anchored=True, radii=[0.10, 0.05, 0.04], min_n=8,
             max_n=64)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """The same seeded weights as the JAX script's pickle and the port's
    ``--save-state`` file."""
    root = tmp_path_factory.mktemp("temporal")
    jsb = _load("jax_synthetic_benchmark_t",
                ROOT / "scripts" / "synthetic_benchmark.py")
    jm = jsb.build_model(C, H, W, GRID, "2d", holdout=C - 1, anchored=True,
                         min_n=8, max_n=64)
    # Seed 1 with Gaussians 10x their unit scale: the held-out alpha
    # passes 0.5 over part of the animal, so the IoU is not 0 (seeds 0 and
    # 2, and smaller scales, render alpha < 0.5 everywhere).
    variables = random_variables(jm.net, jnp.zeros((1, GRID, GRID, GRID, 4)),
                                 seed=1, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(10.0), np.float32)
    jfn = root / "state.pkl"
    with open(jfn, "wb") as f:
        pickle.dump(dict(params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         scene=SCENE), f)
    model = tsb.build_model(C, H, W, GRID, "2d", holdout=C - 1, anchored=True,
                            min_n=8, max_n=64, device="cpu")
    model.net.load_state_dict(variables_from_flax(variables))
    tfn = root / "state.pt"
    torch.save(dict(
        params={k: v.detach() for k, v in model.net.named_parameters()},
        batch_stats={k: v.detach() for k, v in model.net.named_buffers()},
        scene=SCENE), tfn)
    return root, jfn, tfn


@pytest.fixture(scope="module")
def jax_run(states):
    """The JAX script's end-to-end run (its quality pass is the default
    mode's) in interpret mode, with its PNGs kept."""
    root, jfn, _ = states
    mp = pytest.MonkeyPatch()
    mp.chdir(ROOT)
    mp.syspath_prepend(str(ROOT))
    jtb = _load("jax_temporal_benchmark",
                ROOT / "scripts" / "temporal_benchmark.py")
    build = jtb.build_model

    def pallas(*args, **kwargs):
        m = build(*args, **kwargs)
        m.render_mode = "pallas"  # the kernels the port's are held against
        return m

    mp.setattr(jtb, "build_model", pallas)
    out = root / "jax.json"
    mp.setattr(sys, "argv", [
        "temporal_benchmark.py", "--state", str(jfn), "--length",
        str(LENGTH), "--end-to-end", "--disk-frames", str(T),
        "--keep-frames", str(root / "jax_frames"), "--out", str(out)])
    try:
        with pltpu.force_tpu_interpret_mode():
            jtb.main()
    finally:
        mp.undo()
    return json.loads(out.read_text()), root / "jax_frames" / "frames"


def _report_keys(path):
    keys = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "report"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
    return keys


def _pngs(d):
    from PIL import Image

    return [np.asarray(Image.open(p)) for p in sorted(Path(d).glob("*.png"))]


def test_report_and_quality_match_the_jax_script(states, jax_run, capsys):
    _, _, tfn = states
    ref, _ = jax_run
    got = ttb.main(["--state", str(tfn), "--length", str(LENGTH),
                    "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    jkeys = _report_keys(ROOT / "scripts" / "temporal_benchmark.py")
    assert set(ref) == jkeys
    assert set(got) == jkeys | {"decode"}
    assert got["config"] == ref["config"] == "32x32 grid16 2d C3"
    assert got["sequence_frames"] == LENGTH and got["mp4_mux_s"] is None
    assert (got["mode"], got["decode"]) == ("pre-staged device payloads",
                                            "numpy")
    assert got["backend"] == "cpu" and ref["backend"] == "cpu"
    assert got["lpips"] is None and got["lpips_gate"] == ref["lpips_gate"]
    assert abs(got["holdout_psnr_db"] - ref["holdout_psnr_db"]) <= 1e-3
    assert abs(got["holdout_ssim"] - ref["holdout_ssim"]) <= 1e-4
    assert got["holdout_iou"] == ref["holdout_iou"] > 0.2
    assert np.isfinite(got["holdout_psnr_db"]) and got["ms_per_frame"] > 0


def test_end_to_end_pngs(states, jax_run, tmp_path):
    """The port's PNGs equal its default mode's uint8 renders of the same
    frames, and sit within one level of the JAX script's."""
    _, _, tfn = states
    ref, jax_frames = jax_run
    keep = tmp_path / "keep"
    got = ttb.main(["--state", str(tfn), "--length", str(LENGTH),
                    "--end-to-end", "--disk-frames", str(T), "--keep-frames",
                    str(keep), "--device", "cpu"])
    assert got["mode"] == ref["mode"]
    assert got["decode"] == "native"
    assert (keep / "images.h5").exists()
    pngs = _pngs(keep / "frames")
    assert len(pngs) == LENGTH

    model, sc = ttb.load_state(str(tfn), "cpu")
    _, _, frames, centers, angles = tsb.make_scene(C, H, W, T=T)
    read = ttb.staged_reader(model, frames, centers, angles)
    render = ttb.make_render_u8(model, C - 1)
    for i, png in enumerate(pngs):
        u8 = render(*read(i))
        assert u8.dtype == torch.uint8 and u8.shape == (H, W, 3)
        np.testing.assert_array_equal(png, u8.numpy())
    assert (pngs[0] < 250).any()  # the render shows the animal

    jpngs = _pngs(jax_frames)
    assert len(jpngs) == LENGTH
    d = np.abs(np.stack(pngs).astype(int) - np.stack(jpngs))
    share = float((d > 0).mean())
    assert d.max() <= 1, (d.max(), share)
    print(f"uint8 frames of the two packages: {share:.2%} of the values "
          f"differ, by 1")


def test_to_u8_rounds_half_up_and_clamps():
    rgb = torch.tensor([-0.1, 0.0, 0.5 / 255, 0.49 / 255, 1.0, 1.2])
    np.testing.assert_array_equal(ttb.to_u8(rgb).numpy(),
                                  [0, 0, 1, 0, 255, 255])


def test_run_sequence_order_fetch_and_writes():
    """Every frame rendered once, in order, from its read; each write
    receives its own frame, after the render, and all have finished."""
    calls, written = [], {}

    def read(i):
        return (i,)

    def render(i):
        calls.append(i)
        return torch.full((2, 2, 3), i, dtype=torch.uint8)

    def write(i, image):
        written[i] = image.copy()

    secs = ttb.run_sequence(render, read, 7, write)
    assert calls == list(range(7)) and secs > 0
    assert sorted(written) == list(range(7))
    for i, image in written.items():
        assert (image == i).all()
    calls.clear()
    ttb.run_sequence(render, read, 2)
    assert calls == [0, 1]


def test_default_device_is_the_card(states):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tfn = states
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttb.main(["--state", str(tfn), "--length", "1"])
