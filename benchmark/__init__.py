"""The benchmark of ``pose_splatter_torch`` on NVIDIA H100s (see
``harness.py``; run ``python3 -m benchmark.run``)."""
