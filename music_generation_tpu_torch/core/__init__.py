"""Core neural building blocks (PyTorch, channels-last at module edges)."""

from .attention import RelativeMultiHeadAttention, TransformerEncoder
from .flows import (ConvFlow, ElementwiseAffine, LogFlow,
                    ResidualCouplingBlock, ResidualCouplingLayer, flip)
from .layers import (LRELU_SLOPE, FFN, Conv1d, ConvReluNorm, ConvTranspose1d,
                     DDSConv, LayerNorm1d, conv_ntc, dropout)
from .masking import (expand_by_durations, feature_mask, generate_path,
                      rand_slice_segments, sequence_mask, slice_segments)
from .splines import piecewise_rational_quadratic_transform
from .wavenet import WaveNet

__all__ = [
    "RelativeMultiHeadAttention", "TransformerEncoder", "ConvFlow",
    "ElementwiseAffine", "LogFlow", "ResidualCouplingBlock",
    "ResidualCouplingLayer", "flip", "LRELU_SLOPE", "FFN", "Conv1d",
    "ConvReluNorm", "ConvTranspose1d", "DDSConv", "LayerNorm1d", "conv_ntc",
    "dropout", "expand_by_durations", "feature_mask", "generate_path",
    "rand_slice_segments", "sequence_mask", "slice_segments",
    "piecewise_rational_quadratic_transform", "WaveNet",
]
