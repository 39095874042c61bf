"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and none
    is present (entry points never fall back to the CPU quietly).

    On CUDA this also turns TF32 off for cuDNN convolutions and matmuls: the
    port runs in true float32, as the JAX package forces
    ``Precision.HIGHEST`` where it matters (SSIM's variance estimates).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
