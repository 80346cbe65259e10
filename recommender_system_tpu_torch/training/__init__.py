from .harness import FusedAdagrad, FusedAdam, FusedSGD, Trainer
from .losses import bce_with_logits, default_loss, logits_of
from .optim import SGD, Adagrad, Adam, DecayedWeights
