"""PyTorch/CUDA port of ``pose_splatter_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``ops/carving.py``, ``models/unet3d.py``, ``train/loop.py``, ...) so each
counterpart is easy to find. It imports ``torch`` and never ``jax``.

Covered so far: the 2D view-anchored eval forward (carve → residual U-Nets →
Gaussian selection + MLP head → anchored projection → instance binning →
the hand-written CUDA forward compositor → eval loss and metrics).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a CUDA device they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
