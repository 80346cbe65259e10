"""recommender_system_tpu_torch: the PyTorch and CUDA port of
``recommender_system_tpu`` for an NVIDIA H100.

It imports torch and numpy, never JAX nor the JAX package. Entry points run
on the card unless the caller names another device; kernels are written by
hand in ``csrc/`` and built at first use (``ops/kernels.py``).

Ported so far: DCN served through ``Scorer`` and trained, with the cross
stack as a CUDA kernel; DeepFM trained through ``Trainer``, with the fused
sparse Adagrad (``FusedAdagrad``) and the sorted scatter-add of the
lookup's backward as CUDA kernels; DIN served and trained, with the DIN
target attention as a CUDA kernel; WideDeep, NFM, FM and FNN (with
``init_from_fm``) trained, with the fused sparse SGD (``FusedSGD``) and the
lazy sparse Adam (``FusedAdam``) as CUDA kernels; DeepCrossing, PNN (with
FGCNN), AFM and FFM trained through the same sparse kernels;
``FMLayer``, with the FM logit as a CUDA kernel; and DIEN served and
trained (its GRU and AUGRU plain PyTorch loops, its attention the DIN
kernel, its three lookup sites one fused update); DSSM trained with the
in-batch or sampled softmax and served through ``RetrievalIndex``, and MMOE
trained and served, both through the same sparse kernels; the NLP
models (``LSTMClassifier``, ``Transformer``, ``TransformerClassifier``);
and the training CLI, ``python -m recommender_system_tpu_torch.train``
(``ExperimentConfig``), in memory or out of core over a Criteo TSV through
the native parser, with checkpoints; training over tables sharded by row
(and, on a model axis, by column) and MMOE's experts sharded over a
``torch.distributed`` process group (``parallel``: ``make_mesh(data,
model)``, the all-to-all lookups, the sharded fused update;
``Trainer(mesh=...)``, ``--mesh-data`` and ``--mesh-model`` under
``torchrun``); and the classics (logistic regression, ItemCF and UserCF,
matrix factorization) in plain PyTorch on the card, with the host-side
vocabulary encoding (``utils.vocab``) and the timing helpers
(``utils.benchmark``). Every TPU kernel of the JAX package has its
counterpart in ``csrc/``, and every public name of the JAX package has its
counterpart or a stated reason (``tests/test_torch_surface.py``).
"""

from .config import ExperimentConfig
from .models import (AFM, CTR_MODELS, DCN, DIEN, DIN, DSSM, FFM, FM, FNN, MMOE, NFM, PNN,
                     DeepCrossing, DeepFM, LSTMClassifier, Transformer, TransformerClassifier,
                     WideDeep, init_from_fm)
from .parallel import Mesh, make_mesh
from .serving import RetrievalIndex, Scorer
from .training import FusedAdagrad, FusedAdam, FusedSGD, Trainer

__all__ = ["AFM", "CTR_MODELS", "DCN", "DIEN", "DIN", "DSSM", "DeepCrossing", "DeepFM",
           "ExperimentConfig", "FFM", "FM", "FNN", "FusedAdagrad", "FusedAdam", "FusedSGD",
           "LSTMClassifier", "MMOE", "Mesh", "NFM", "PNN", "RetrievalIndex", "Scorer", "Trainer",
           "Transformer", "TransformerClassifier", "WideDeep", "init_from_fm", "make_mesh"]
