"""GPT-2 lyric generator (decoder-only LM, KV-cached greedy decoding).

Twin of music_generation_tpu/models/lyrics/gpt2.py. Parity target:
Lyric_generator/generator.py — 10-layer / 768-d / 12-head GPT-2, greedy
decoding with no_repeat_ngram_size=2, style control tokens,
'[CLS] title [SEP] style [SEP]' prompt layout. Attention is scaled by
1/sqrt(d_k); the LM head is tied to the token embedding.

The decode is a Python loop of one-token steps over per-layer KV caches
[B, T_max, H, Dk], updated in place; nothing in the loop waits for the
device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..melody.transformer import _dense

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 21136     # 21128 wordpiece + 8 style/control specials
    n_layer: int = 10
    n_embd: int = 768
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.1


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def _embed(n: int, d: int) -> nn.Embedding:
    """nn.Embedding scaled as flax's default init (normal, std d ** -0.5)."""
    emb = nn.Embedding(n, d)
    nn.init.normal_(emb.weight, std=d ** -0.5)
    return emb


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        c = self.cfg = cfg
        self.ln_1 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)
        self.qkv = _dense(c.n_embd, 3 * c.n_embd)
        self.attn_proj = _dense(c.n_embd, c.n_embd)
        self.ln_2 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)
        self.mlp_fc = _dense(c.n_embd, 4 * c.n_embd)
        self.mlp_proj = _dense(4 * c.n_embd, c.n_embd)

    def _split_heads(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.cfg.n_head, -1).transpose(1, 2)

    def _mlp(self, x):
        return self.mlp_proj(gelu_new(self.mlp_fc(self.ln_2(x))))

    def forward(self, x, causal_mask):
        q, k, v = map(self._split_heads,
                      self.qkv(self.ln_1(x)).chunk(3, dim=-1))
        scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(causal_mask == 0, NEG_INF)
        o = torch.softmax(scores, dim=-1) @ v
        x = x + self.attn_proj(o.transpose(1, 2).reshape(x.shape))
        return x + self._mlp(x)

    def step(self, x, cache_k, cache_v, pos: int):
        """One-token step. x: [B, 1, C]; caches [B, T_max, H, Dk], written
        in place at ``pos``. Attends over positions 0..pos (the JAX twin
        masks the rest of the cache to -1e9, which softmax zeroes)."""
        b = x.shape[0]
        q, k, v = (t.reshape(b, self.cfg.n_head, -1)
                   for t in self.qkv(self.ln_1(x)).chunk(3, dim=-1))
        cache_k[:, pos] = k
        cache_v[:, pos] = v
        keys, values = cache_k[:, : pos + 1], cache_v[:, : pos + 1]
        scores = torch.einsum("bhd,bthd->bht", q, keys) / math.sqrt(
            q.shape[-1])
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bht,bthd->bhd", p, values).reshape(b, 1, -1)
        x = x + self.attn_proj(o)
        return x + self._mlp(x)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        c = self.cfg = cfg
        self.wte = _embed(c.vocab_size, c.n_embd)
        self.wpe = _embed(c.n_positions, c.n_embd)
        self.h = nn.ModuleList(GPT2Block(c) for _ in range(c.n_layer))
        self.ln_f = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)

    def _logits(self, x):
        # tied LM head (GPT2LMHeadModel convention)
        return x @ self.wte.weight.T

    def forward(self, ids):
        t = ids.shape[1]
        x = self.wte(ids) + self.wpe(torch.arange(t, device=ids.device))[None]
        mask = torch.tril(torch.ones(t, t, dtype=torch.int32,
                                     device=ids.device))[None, None]
        for blk in self.h:
            x = blk(x, mask)
        return self._logits(self.ln_f(x))

    def decode_step(self, token, pos: int, caches):
        """token [B] -> (logits [B, V], caches updated in place)."""
        x = (self.wte(token[:, None]) + self.wpe.weight[pos])
        for blk, (ck, cv) in zip(self.h, caches):
            x = blk.step(x, ck, cv, pos)
        return self._logits(self.ln_f(x))[:, 0], caches


def init_cache(cfg: GPT2Config, batch: int, max_len: int, device=None):
    d_k = cfg.n_embd // cfg.n_head
    shape = (batch, max_len, cfg.n_head, d_k)
    return tuple((torch.zeros(shape, device=device),
                  torch.zeros(shape, device=device))
                 for _ in range(cfg.n_layer))


def _ban_repeated_bigrams(logits, tokens, step: int, vocab_size: int):
    """no_repeat_ngram_size=2: ban token v if (last, v) already occurred
    at a position before ``step`` of the token buffer."""
    last = tokens[:, step]
    prev, nxt = tokens[:, :-1], tokens[:, 1:]
    pos_valid = torch.arange(prev.shape[1], device=tokens.device)[None] < step
    matches = ((prev == last[:, None]) & pos_valid).to(torch.int32)
    hits = torch.zeros((tokens.shape[0], vocab_size), dtype=torch.int32,
                       device=tokens.device).scatter_add_(1, nxt, matches)
    return logits.masked_fill(hits > 0, NEG_INF)


@torch.no_grad()
def greedy_generate(model: GPT2, input_ids: torch.Tensor,
                    prompt_len: torch.Tensor, max_length: int = 90,
                    no_repeat_ngram: int = 2) -> torch.Tensor:
    """Greedy decode. input_ids: [B, max_length] buffer with the prompt at
    the front (rest PAD); prompt_len: [B] actual prompt lengths. Returns
    the filled token buffer [B, max_length] (int64)."""
    cfg = model.cfg
    tokens = input_ids.to(torch.int64).clone()
    prompt_len = prompt_len.to(tokens.device)
    caches = init_cache(cfg, tokens.shape[0], max_length, tokens.device)
    for pos in range(max_length - 1):
        logits, caches = model.decode_step(tokens[:, pos], pos, caches)
        if no_repeat_ngram == 2:
            logits = _ban_repeated_bigrams(logits, tokens, pos,
                                           cfg.vocab_size)
        nxt = logits.argmax(dim=-1)
        # Inside the prompt, keep the given token; else write the prediction.
        in_prompt = (pos + 1) < prompt_len
        tokens[:, pos + 1] = torch.where(in_prompt, tokens[:, pos + 1], nxt)
    return tokens
