from .harness import FusedAdagrad, FusedAdam, FusedSGD, Trainer
from .losses import (NegativeSampler, bce_with_logits, default_loss, inbatch_softmax_loss,
                     logits_of, sampled_softmax_loss)
from .optim import SGD, Adagrad, Adam, DecayedWeights
