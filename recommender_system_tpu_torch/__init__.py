"""recommender_system_tpu_torch: the PyTorch and CUDA port of
``recommender_system_tpu`` for an NVIDIA H100.

It imports torch and numpy, never JAX nor the JAX package. Entry points run
on the card unless the caller names another device; kernels are written by
hand in ``csrc/`` and built at first use (``ops/kernels.py``).

Ported so far: DCN served through ``Scorer``, with the cross stack as a CUDA
kernel.
"""

from .models import DCN
from .serving import Scorer

__all__ = ["DCN", "Scorer"]
