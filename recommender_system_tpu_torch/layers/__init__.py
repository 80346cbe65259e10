from .core import DNN, BatchNorm, Dice, PReLU, PredictionLayer, activation_fn
from .embedding import EmbeddingCollection, EmbedOutputs, build_table_specs
from .interaction import CrossNet, FMLayer
from .sequence import DinAttention
