"""recommender_system_tpu_torch: the PyTorch and CUDA port of
``recommender_system_tpu`` for an NVIDIA H100.

It imports torch and numpy, never JAX nor the JAX package. Entry points run
on the card unless the caller names another device; kernels are written by
hand in ``csrc/`` and built at first use (``ops/kernels.py``).

Ported so far: DCN served through ``Scorer``, with the cross stack as a CUDA
kernel; DeepFM trained through ``Trainer``, with the fused sparse Adagrad
(``FusedAdagrad``) and the sorted scatter-add of the lookup's backward as
CUDA kernels; DIN served and trained, with the DIN target attention as a
CUDA kernel.
"""

from .models import DCN, DIN, DeepFM
from .serving import Scorer
from .training import FusedAdagrad, Trainer

__all__ = ["DCN", "DIN", "DeepFM", "FusedAdagrad", "Scorer", "Trainer"]
