from .harness import FusedAdagrad, FusedAdam, FusedSGD, Trainer
from .losses import bce_with_logits
from .optim import SGD, Adagrad, Adam
