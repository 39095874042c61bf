"""PyTorch/CUDA port of ``pose_splatter_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``ops/carving.py``, ``models/unet3d.py``, ``train/loop.py``, ...) so each
counterpart is easy to find. It imports ``torch`` and never ``jax``.

Covered: the 2D (view-anchored) and 3D models in eval and train
(carve → residual U-Nets → Gaussian selection + MLP head → projection →
binning → the hand-written CUDA compositors, or the ``"tiled"`` and
``"global"`` compositors in plain PyTorch → losses, Adam, K steps a call),
the renderer facade, the carve's visibility cap, the adaptive camera,
``remat_unets``, checkpoints that cross to and from the JAX package
(``train/checkpoint_convert.py``), the counterparts of ``bench.py``
(``scripts/bench.py``), ``__graft_entry__.py::entry`` (``graft_entry.py``)
and ``scripts/synthetic_benchmark.py``, and preprocessing
(``preprocess/``, ``tracking.py``, ``scripts/preprocess.py``: the
center/rotation and crop carves on the device, the visual-pose features
through ResNet18 in ``models/resnet.py``) with LPIPS (``ops/lpips.py``),
and the output layer: the evaluation's metrics (``train/evaluate.py``),
novel views, export and plots (``viz/``), profiling and log analysis
(``utils/profiling.py``, ``utils/loganalysis.py``) and the user CLIs
(``scripts/train.py``, ``evaluate.py``, ``render_image.py``,
``generate_videos.py``, ``export_gaussians.py``, ``visualize.py``,
``profile.py``, ``analyze_convergence.py``), serving a recording and its
input side (``scripts/temporal_benchmark.py``,
``scripts/dbg_input_pipeline.py``, the native frame decode in
``data/native.py`` over ``csrc/fastio.cpp``) and the utility scripts
(``scripts/doctor.py``, ``dataset_utils.py``, ``organize_export.py``,
``estimate_up_direction.py`` and the ``run_*.sh`` wrappers), and
multi-rank training over ``torch.distributed`` (``parallel/``: the
data-parallel and (data, tile) steps, ``graft_entry.py::dryrun_multichip``,
``scripts/scaling.py``, ``scripts/dbg_highres_sharded.py``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a CUDA device they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
