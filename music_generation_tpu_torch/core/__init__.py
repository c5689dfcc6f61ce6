"""Core neural building blocks (PyTorch, channels-last at module edges)."""

from .attention import RelativeMultiHeadAttention, TransformerEncoder
from .flows import ResidualCouplingBlock, ResidualCouplingLayer, flip
from .layers import (LRELU_SLOPE, FFN, Conv1d, ConvTranspose1d, LayerNorm1d,
                     conv_ntc, dropout)
from .masking import (expand_by_durations, feature_mask, rand_slice_segments,
                      sequence_mask, slice_segments)
from .wavenet import WaveNet

__all__ = [
    "RelativeMultiHeadAttention", "TransformerEncoder",
    "ResidualCouplingBlock", "ResidualCouplingLayer", "flip", "LRELU_SLOPE",
    "FFN", "Conv1d", "ConvTranspose1d", "LayerNorm1d", "conv_ntc", "dropout",
    "expand_by_durations", "feature_mask", "rand_slice_segments",
    "sequence_mask", "slice_segments",
    "WaveNet",
]
