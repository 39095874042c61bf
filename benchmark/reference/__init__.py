"""The plain reference the benchmark holds the program against.

Plain PyTorch, float32, no kernels: the model's forward (carve, U-Nets,
selection, Gaussian head, projection, binning, compositing), its losses,
gradients by autograd and the Adam update. It imports nothing of the
program; the semantics follow what the program and the JAX package both
document (the selection's float32 threshold loops, the binning's caps of
``tile_expand`` tiles a Gaussian and 4N + T·G rows a camera, with the
dropped rows counted).
"""
