from .harness import FusedAdagrad, Trainer
from .losses import bce_with_logits
from .optim import Adagrad, Adam
