"""T5 lyric generator (encoder-decoder, top-k sampled decoding).

Twin of music_generation_tpu/models/lyrics/t5.py. Parity target:
Lyric_generator_t5/generator.py — Mengzi-T5-base (12+12 layers, d_model
768, d_kv 64, gated-gelu, relative attention 32 buckets, untied
embeddings), prompt "关键词：{kw} 长度：15", top_k=10 sampling.

What is particular to this T5, and kept: attention scores carry no
1/sqrt(d) scale; masks are applied with where(mask == 0, -1e9), not added;
the relative bias of the first layer (computed in float32 with the JAX
package's bucket arithmetic) is reused by every layer; cross-attention
has no bias; the FFN is gated GELU with the tanh approximation; the LM
head is untied and not rescaled.

Decode: the encoder runs once, the cross-attention K/V of every decoder
layer are computed once per request, and a Python loop of one-token
steps writes per-layer self-attention caches [B, T_max, H, Dk] in place.

Random init follows T5's own scheme (normal; q std (d_model * d_kv)^-0.5,
k/v/wi std d_model^-0.5, o std (H * d_kv)^-0.5, wo std d_ff^-0.5,
relative bias std d_model^-0.5, embedding and untied head std 1), which
keeps the unscaled attention scores near unit variance. With flax's
default (q std d_model^-0.5, as the JAX package initialises) the scores
have std sqrt(d_kv) = 8 and the random 24-layer net is chaotic: at full
width its float32 logits on an H100 differed from the CPU's by 2.1e-3
relative L2 (chip_smoke.py, lyrics phase), against 1.2e-6 with this init.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .gpt2 import _ban_repeated_bigrams

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    decoder_start_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 0


def _linear(d_in: int, d_out: int, std: float) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=False)
    nn.init.normal_(lin.weight, std=std)
    return lin


def _embed(n: int, d: int, std: float) -> nn.Embedding:
    emb = nn.Embedding(n, d)
    nn.init.normal_(emb.weight, std=std)
    return emb


class RMSNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.epsilon) * self.weight


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """The JAX package's bucketing, float32 step for step (a log of
    n / max_exact + 1e-6, divided, scaled and truncated), not HF's."""
    ret = 0
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = (n < 0).to(torch.int64) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int64)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 bidirectional: bool = True):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.q = _linear(d, inner, (d * cfg.d_kv) ** -0.5)
        self.k = _linear(d, inner, d ** -0.5)
        self.v = _linear(d, inner, d ** -0.5)
        self.o = _linear(inner, d, inner ** -0.5)
        if has_relative_bias:
            self.rel_bias = _embed(cfg.relative_attention_num_buckets,
                                   cfg.num_heads, d ** -0.5)

    def _heads(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.cfg.num_heads, self.cfg.d_kv).transpose(
            1, 2)

    def compute_bias(self, q_len: int, k_len: int, q_offset: int = 0):
        device = self.rel_bias.weight.device
        ctx = torch.arange(q_len, device=device)[:, None] + q_offset
        mem = torch.arange(k_len, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional,
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.rel_bias(buckets).permute(2, 0, 1)[None]  # [1,H,Q,K]

    def kv_heads(self, kv):
        """Keys and values of ``kv`` as [B, H, T, Dk]."""
        return self._heads(self.k(kv)), self._heads(self.v(kv))

    def attend(self, x, k, v, mask=None, bias=None):
        q = self._heads(self.q(x))
        scores = q @ k.transpose(-1, -2)  # T5: no 1/sqrt(d) scale
        if bias is not None:
            scores = scores + bias
        if mask is not None:
            scores = scores.masked_fill(mask == 0, NEG_INF)
        out = torch.softmax(scores, dim=-1) @ v
        b, h, t, d = out.shape
        return self.o(out.transpose(1, 2).reshape(b, t, h * d))

    def forward(self, x, kv, mask=None, bias=None):
        return self.attend(x, *self.kv_heads(kv), mask, bias)

    def step(self, x, cache_k, cache_v, pos: int, bias_row=None):
        """Single-position self-attention with a cache written in place at
        ``pos``. x: [B, 1, C]; bias_row [1, H, K] with K > pos. Attends
        over positions 0..pos (the JAX twin masks the rest to -1e9)."""
        c = self.cfg
        b = x.shape[0]
        q = self.q(x).reshape(b, c.num_heads, c.d_kv)
        cache_k[:, pos] = self.k(x).reshape(b, c.num_heads, c.d_kv)
        cache_v[:, pos] = self.v(x).reshape(b, c.num_heads, c.d_kv)
        scores = torch.einsum("bhd,bthd->bht", q, cache_k[:, : pos + 1])
        if bias_row is not None:
            scores = scores + bias_row[..., : pos + 1]
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bht,bthd->bhd", p, cache_v[:, : pos + 1])
        return self.o(out.reshape(b, 1, -1))


class T5FFN(nn.Module):
    """Gated GELU (T5 v1.1 / Mengzi)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = _linear(cfg.d_model, cfg.d_ff, cfg.d_model ** -0.5)
        self.wi_1 = _linear(cfg.d_model, cfg.d_ff, cfg.d_model ** -0.5)
        self.wo = _linear(cfg.d_ff, cfg.d_model, cfg.d_ff ** -0.5)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.attn = T5Attention(cfg, has_relative_bias, True)
        self.norm1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ffn = T5FFN(cfg)
        self.norm2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, mask, bias):
        h = self.norm1(x)
        x = x + self.attn(h, h, mask, bias)
        return x + self.ffn(self.norm2(x))


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.self_attn = T5Attention(cfg, has_relative_bias, False)
        self.norm1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.cross_attn = T5Attention(cfg, False, True)
        self.norm2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ffn = T5FFN(cfg)
        self.norm3 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def step(self, x, cross_kv, memory_mask, cache_k, cache_v, pos: int,
             bias_row):
        """One decode position; ``cross_kv`` is cross_attn.kv_heads(memory),
        computed once per request."""
        x = x + self.self_attn.step(self.norm1(x), cache_k, cache_v, pos,
                                    bias_row)
        x = x + self.cross_attn.attend(self.norm2(x), *cross_kv, memory_mask)
        return x + self.ffn(self.norm3(x))

    def forward(self, x, memory, memory_mask, causal, bias):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, causal, bias)
        x = x + self.cross_attn(self.norm2(x), memory, memory_mask)
        return x + self.ffn(self.norm3(x))


class T5(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        c = self.cfg = cfg
        self.shared = _embed(c.vocab_size, c.d_model, 1.0)
        self.enc = nn.ModuleList(T5EncoderLayer(c, i == 0)
                                 for i in range(c.num_layers))
        self.enc_norm = RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.dec = nn.ModuleList(T5DecoderLayer(c, i == 0)
                                 for i in range(c.num_decoder_layers))
        self.dec_norm = RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.lm_head = _linear(c.d_model, c.vocab_size, 1.0)

    def encode(self, ids, mask):
        x = self.shared(ids)
        attn_mask = mask[:, None, None, :]
        # the first layer's relative bias, reused by every layer
        bias = self.enc[0].attn.compute_bias(ids.shape[1], ids.shape[1])
        for layer in self.enc:
            x = layer(x, attn_mask, bias)
        return self.enc_norm(x)

    def forward(self, src_ids, src_mask, tgt_ids):
        """Full (teacher-forced) forward -> logits [B, T_tgt, V]."""
        memory = self.encode(src_ids, src_mask)
        t = tgt_ids.shape[1]
        x = self.shared(tgt_ids)
        causal = torch.tril(torch.ones(t, t, dtype=torch.int32,
                                       device=x.device))[None, None]
        bias = self.dec[0].self_attn.compute_bias(t, t)
        mem_mask = src_mask[:, None, None, :]
        for layer in self.dec:
            x = layer(x, memory, mem_mask, causal, bias)
        return self.lm_head(self.dec_norm(x))

    def decoder_bias_row(self, pos: int, max_len: int):
        """Relative self-attn bias for one decode position: [1, H, K]."""
        return self.dec[0].self_attn.compute_bias(
            1, max_len, q_offset=pos)[0, :, 0][None]

    def cross_kv(self, memory):
        """Every decoder layer's cross-attention K/V of ``memory``."""
        return [layer.cross_attn.kv_heads(memory) for layer in self.dec]

    def decode_step(self, token, pos: int, cross_kv, memory_mask, caches,
                    bias_row):
        """token [B] at position ``pos`` -> (logits [B, V], caches updated
        in place). ``cross_kv`` from cross_kv(memory); ``bias_row`` from
        decoder_bias_row(pos, max_len) or a row of the full bias table."""
        x = self.shared(token[:, None])
        mem_mask = memory_mask[:, None, None, :]
        for layer, kv, (ck, cv) in zip(self.dec, cross_kv, caches):
            x = layer.step(x, kv, mem_mask, ck, cv, pos, bias_row)
        # Mengzi: untied embeddings -> independent lm_head, no rescale
        return self.lm_head(self.dec_norm(x))[:, 0], caches


def init_t5_cache(cfg: T5Config, batch: int, max_len: int, device=None):
    shape = (batch, max_len, cfg.num_heads, cfg.d_kv)
    return tuple((torch.zeros(shape, device=device),
                  torch.zeros(shape, device=device))
                 for _ in range(cfg.num_decoder_layers))


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from ``generator`` (uniform clamped away from
    0, as jax.random.gumbel does)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def topk_sample_generate(model: T5, generator: torch.Generator,
                         src_ids: torch.Tensor, src_mask: torch.Tensor,
                         max_length: int = 128, top_k: int = 10,
                         no_repeat_ngram: int = 2) -> torch.Tensor:
    """Encoder once + sampled decode. Returns token buffer [B, max_length].

    Each step draws categorically over the top ``top_k`` logits (Gumbel-max
    with noise from ``generator``; at top_k=1 the draw is the argmax), with
    repeated bigrams banned as in the reference's GPT-2 generator. After
    EOS a row writes pad."""
    cfg = model.cfg
    device = src_ids.device
    batch = src_ids.shape[0]
    memory = model.encode(src_ids, src_mask)
    cross = model.cross_kv(memory)
    caches = init_t5_cache(cfg, batch, max_length, device)
    # row `pos` of this table is decoder_bias_row(pos, max_length)
    bias = model.dec[0].self_attn.compute_bias(max_length, max_length)
    tokens = torch.full((batch, max_length + 1), cfg.pad_token_id,
                        dtype=torch.int64, device=device)
    tokens[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    pad = torch.tensor(cfg.pad_token_id, device=device)
    for pos in range(max_length):
        logits, caches = model.decode_step(tokens[:, pos], pos, cross,
                                           src_mask, caches, bias[:, :, pos])
        if no_repeat_ngram == 2:
            logits = _ban_repeated_bigrams(logits, tokens, pos,
                                           cfg.vocab_size)
        vals, idx = torch.topk(logits, top_k, dim=-1)
        choice = (vals + _gumbel(vals.shape, generator, device)).argmax(
            dim=-1, keepdim=True)
        nxt = idx.gather(1, choice)[:, 0]
        nxt = torch.where(finished, pad, nxt)
        finished |= nxt == cfg.eos_token_id
        tokens[:, pos + 1] = nxt
    return tokens[:, 1:]
