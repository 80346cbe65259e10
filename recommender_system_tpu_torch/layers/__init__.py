from .core import DNN, Dice, PReLU, PredictionLayer, activation_fn
from .embedding import EmbeddingCollection, EmbedOutputs, build_table_specs
from .interaction import CrossNet
