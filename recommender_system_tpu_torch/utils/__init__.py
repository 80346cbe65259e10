"""Framework-free utilities, copied from the JAX package, and the timing
helpers (``benchmark``)."""
from . import benchmark, datasets, features, hashing, metrics, vocab
from .features import (DenseFeat, SparseFeat, VarLenSparseFeat, auto_embedding_dim, batch_spec,
                       get_feature_names, split_columns)
