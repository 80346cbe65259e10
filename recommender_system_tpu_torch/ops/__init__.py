"""Ops: plain PyTorch versions, CUDA kernels and the rule between them."""
from . import interactions, rnn, seqpool
from .interactions import (bi_interaction, cross_network, ffm_interaction, fm_interaction,
                           pairwise_inner, pairwise_outer, pairwise_product)
from .rnn import augru, gru, lstm
from .seqpool import id_mask, length_mask, masked_softmax, sequence_pooling, weighted_sequence
