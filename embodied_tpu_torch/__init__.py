"""embodied_tpu_torch: the PyTorch/CUDA port of embodied_tpu.

A second package beside the JAX one, with the same layout, so every file
has an obvious counterpart. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package becomes a kernel written by hand for Hopper
(`csrc/`). The port imports nothing of JAX or of `embodied_tpu`.
"""

__version__ = '0.1.0'
