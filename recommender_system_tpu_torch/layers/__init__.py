from .core import DNN, BatchNorm, Dice, PReLU, PredictionLayer, activation_fn
from .embedding import (EmbeddingCollection, EmbedOutputs, LinearEmbedding, UnifiedEmbedding,
                        build_table_specs)
from .interaction import (FGCNN, AFMAttention, CrossNet, FMLayer, InnerProductLayer,
                          MMoELayer, OuterProductLayer, ResBlock, TowerLayer)
from .sequence import AUGRULayer, DinAttention, GRULayer
