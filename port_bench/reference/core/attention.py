"""Windowed relative-position multi-head attention + FFT-block encoder.

Twin of music_generation_tpu/core/attention.py (VISinger/attentions.py:
window_size=4 learned relative key/value embeddings shared across heads,
post-norm residual blocks). Layout [B, T, C]; masks [B, T, 1].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FFN, Conv1d, LayerNorm1d, conv_ntc, dropout

MASK_VALUE = -1e4


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] relative logits -> [B, H, T, T] absolute."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    return x.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, T] attention weights -> [B, H, T, 2T-1] relative."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(b, h, t * t + t * (t - 1))
    x = F.pad(x, (t, 0))
    return x.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def _window_embeddings(emb: torch.Tensor, length: int,
                       window: int) -> torch.Tensor:
    """Select/pad the [1, 2w+1, D] learned window embeddings to [2T-1, D]."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[0, start: start + 2 * length - 1]


class RelativeMultiHeadAttention(nn.Module):
    """Self-attention with windowed relative key/value embeddings."""

    def __init__(self, channels: int, n_heads: int, window_size: int = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.channels, self.n_heads, self.window_size = \
            channels, n_heads, window_size
        self.dropout_rate = dropout_rate
        d_k = channels // n_heads
        self.q = Conv1d(channels, channels, 1)
        self.k = Conv1d(channels, channels, 1)
        self.v = Conv1d(channels, channels, 1)
        self.out = Conv1d(channels, channels, 1)
        for conv in (self.q, self.k, self.v):
            nn.init.xavier_uniform_(conv.weight[..., 0])
        self.emb_rel_k = nn.Parameter(
            torch.randn(1, 2 * window_size + 1, d_k) * d_k ** -0.5)
        self.emb_rel_v = nn.Parameter(
            torch.randn(1, 2 * window_size + 1, d_k) * d_k ** -0.5)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C]; attn_mask [B, 1, T, T] (0 = masked)."""
        b, t, c = x.shape
        h, d_k = self.n_heads, c // self.n_heads

        def heads(y):
            return y.reshape(b, t, h, d_k).transpose(1, 2)

        q = heads(conv_ntc(self.q, x)) * d_k ** -0.5
        k = heads(conv_ntc(self.k, x))
        v = heads(conv_ntc(self.v, x))
        scores = q @ k.transpose(-1, -2)
        # the relative embeddings take the activations' dtype (_at_dtype)
        rel_k = _window_embeddings(self.emb_rel_k.to(q.dtype), t,
                                   self.window_size)
        scores = scores + _relative_to_absolute(q @ rel_k.T)
        scores = scores.masked_fill(attn_mask == 0, MASK_VALUE)
        p = torch.softmax(scores, dim=-1)
        p = dropout(p, self.dropout_rate, deterministic, generator)
        out = p @ v
        rel_v = _window_embeddings(self.emb_rel_v.to(p.dtype), t,
                                   self.window_size)
        out = out + _absolute_to_relative(p) @ rel_v
        return conv_ntc(self.out, out.transpose(1, 2).reshape(b, t, c))


class TransformerEncoder(nn.Module):
    """Stack of post-norm FFT blocks with windowed relative self-attention
    (attentions.Encoder of the reference)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 dropout_rate: float = 0.0, window_size: int = 4):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attn = nn.ModuleList(
            RelativeMultiHeadAttention(hidden_channels, n_heads, window_size,
                                       dropout_rate)
            for _ in range(n_layers))
        self.norm1 = nn.ModuleList(
            LayerNorm1d(hidden_channels) for _ in range(n_layers))
        self.ffn = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels,
                kernel_size, dropout_rate) for _ in range(n_layers))
        self.norm2 = nn.ModuleList(
            LayerNorm1d(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = mask[..., 0]
        attn_mask = (m[:, None, None, :] * m[:, None, :, None])
        x = x * mask
        for attn, norm1, ffn, norm2 in zip(self.attn, self.norm1, self.ffn,
                                           self.norm2):
            y = attn(x, attn_mask, deterministic, generator)
            x = norm1(x + dropout(y, self.dropout_rate, deterministic,
                                  generator))
            y = ffn(x, mask, deterministic, generator)
            x = norm2(x + dropout(y, self.dropout_rate, deterministic,
                                  generator))
        return x * mask
