"""Melody transformer (lyric -> note enc-dec) and the duration models.

Twin of MelodyTransformer, MSEDurationModel and SDPDurationModel in
music_generation_tpu/models/melody/transformer.py: the "annotated
transformer" with pre-norm sublayers, a final LayerNorm, sinusoidal
positions and emb * sqrt(d), plus the cross-sentence memory (the
reference's ``dotattention``, or the concatenated one of
``prev_mode="concat"``); the SDP variant's post-norm encoder with learned
positions feeding the stochastic duration predictor. LayerNorms use flax's
default eps, 1e-6. Every forward takes ``deterministic`` (default True:
no dropout) and the ``generator`` its dropout masks are drawn from, where
the JAX modules take a dropout rng.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.layers import dropout
from ..duration import StochasticDurationPredictor

MASK_VALUE = -1e9
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MelodyConfig:
    src_vocab: int = 4000
    tgt_vocab: int = 37          # note_dictionary: 4 reserved + 33 pitches
    n_layers: int = 6
    d_model: int = 512
    d_ff: int = 2048
    n_heads: int = 8
    dropout: float = 0.1
    max_len: int = 512
    # the cross-sentence channel: "reference" (the decoder memory is the
    # encoder rows mixed by the previous notes' attention over them) or
    # "concat" (the decoder attends over [encoder rows | previous note
    # embeddings]); the JAX package's MelodyConfig.prev_mode. The same
    # parameters serve both.
    prev_mode: str = "reference"


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def causal_mask(length: int, device=None) -> torch.Tensor:
    """[1, 1, L, L] lower-triangular mask."""
    return torch.tril(torch.ones(length, length, dtype=torch.int32,
                                 device=device))[None, None]


class TokenEmbedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dropout_rate: float = 0.0,
                 max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.lut = nn.Embedding(vocab, d_model)
        nn.init.normal_(self.lut.weight, std=vocab ** -0.5)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(
                max_len, d_model)), persistent=False)

    def forward(self, ids: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.lut(ids) * math.sqrt(self.d_model)
        return dropout(x + self.pe[None, : x.shape[1]], self.dropout_rate,
                       deterministic, generator)


def _dense(d_in: int, d_out: int) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.trunc_normal_(lin.weight, std=d_in ** -0.5)
    nn.init.zeros_(lin.bias)
    return lin


class MHA(nn.Module):
    """Multi-head attention; dropout on the attention probabilities."""

    def __init__(self, d_model: int, n_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.dropout_rate = dropout_rate
        self.q, self.k, self.v = (_dense(d_model, d_model) for _ in range(3))
        self.out = _dense(d_model, d_model)

    def forward(self, q, k, v, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, d = q.shape[0], q.shape[-1]
        h, d_k = self.n_heads, d // self.n_heads

        def heads(x, lin):
            return lin(x).reshape(b, x.shape[1], h, d_k).transpose(1, 2)

        Q, K, V = heads(q, self.q), heads(k, self.k), heads(v, self.v)
        scores = Q @ K.transpose(-1, -2) / math.sqrt(d_k)
        if mask is not None:
            scores = scores.masked_fill(mask == 0, MASK_VALUE)
        p = dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                    deterministic, generator)
        out = p @ V
        return self.out(out.transpose(1, 2).reshape(b, q.shape[1], d))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc1 = _dense(d_model, d_ff)
        self.fc2 = _dense(d_ff, d_model)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = dropout(torch.relu(self.fc1(x)), self.dropout_rate,
                    deterministic, generator)
        return self.fc2(h)


class PreNormBlock(nn.Module):
    """x + dropout(sublayer(LN(x))) — the annotated-transformer sublayer
    (``residual``; ``run`` calls the sublayer on the normed input)."""

    def __init__(self, d_model: int, sublayer: nn.Module,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.sublayer = sublayer

    def residual(self, x, run, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
        return x + dropout(run(self.norm(x)), self.dropout_rate,
                           deterministic, generator)


class MelodyEncoder(nn.Module):
    def __init__(self, cfg: MelodyConfig):
        super().__init__()
        d, r = cfg.d_model, cfg.dropout
        self.attn_res = nn.ModuleList(
            PreNormBlock(d, MHA(d, cfg.n_heads, r), r)
            for _ in range(cfg.n_layers))
        self.ff_res = nn.ModuleList(
            PreNormBlock(d, FeedForward(d, cfg.d_ff, r), r)
            for _ in range(cfg.n_layers))
        self.final_norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, src_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        kw = {"deterministic": deterministic, "generator": generator}
        for attn, ff in zip(self.attn_res, self.ff_res):
            x = attn.residual(
                x, lambda h: attn.sublayer(h, h, h, src_mask, **kw), **kw)
            x = ff.residual(x, lambda h: ff.sublayer(h, **kw), **kw)
        return self.final_norm(x)


class MelodyDecoder(nn.Module):
    def __init__(self, cfg: MelodyConfig):
        super().__init__()
        d, r = cfg.d_model, cfg.dropout
        self.self_res = nn.ModuleList(
            PreNormBlock(d, MHA(d, cfg.n_heads, r), r)
            for _ in range(cfg.n_layers))
        self.cross_res = nn.ModuleList(
            PreNormBlock(d, MHA(d, cfg.n_heads, r), r)
            for _ in range(cfg.n_layers))
        self.ffn_res = nn.ModuleList(
            PreNormBlock(d, FeedForward(d, cfg.d_ff, r), r)
            for _ in range(cfg.n_layers))
        self.final_norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, memory, src_mask, tgt_mask,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        kw = {"deterministic": deterministic, "generator": generator}
        for sa, ca, ff in zip(self.self_res, self.cross_res, self.ffn_res):
            x = sa.residual(
                x, lambda h: sa.sublayer(h, h, h, tgt_mask, **kw), **kw)
            x = ca.residual(x, lambda h: ca.sublayer(h, memory, memory,
                                                     src_mask, **kw), **kw)
            x = ff.residual(x, lambda h: ff.sublayer(h, **kw), **kw)
        return self.final_norm(x)


class MelodyTransformer(nn.Module):
    """Lyric -> note sequence model with previous-sentence memory."""

    def __init__(self, cfg: MelodyConfig):
        super().__init__()
        self.cfg = cfg
        self.src_embed = TokenEmbedding(cfg.src_vocab, cfg.d_model,
                                        cfg.dropout)
        self.tgt_embed = TokenEmbedding(cfg.tgt_vocab, cfg.d_model,
                                        cfg.dropout)
        self.encoder = MelodyEncoder(cfg)
        self.decoder = MelodyDecoder(cfg)
        self.generator = _dense(cfg.d_model, cfg.tgt_vocab)
        # PAD/UNK/BOS (ids 0-2) are never notes: start their logits low so
        # an untrained model emits pitches the score frontend can read
        with torch.no_grad():
            self.generator.bias[:3] = -10.0

    def encode(self, src, src_mask, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        return self.encoder(self.src_embed(src, deterministic, generator),
                            src_mask, deterministic, generator)

    def dot_attention_memory(self, src, src_mask, previous_ids,
                             deterministic: bool = True,
                             generator: Optional[torch.Generator] = None):
        """The previous sentence's note embeddings attend over the encoder
        outputs; the mixtures replace the decoder memory
        (transformer_melody/model.py:349-362 of the reference)."""
        memory = self.encode(src, src_mask, deterministic, generator)
        prev = self.tgt_embed(previous_ids, deterministic, generator)
        interact = prev @ memory.transpose(1, 2)
        interact = interact + (src_mask[:, 0].to(torch.int32) - 1) * 1e-9
        return torch.softmax(interact, dim=-1) @ memory

    def prev_memory(self, src, src_mask, previous_ids, prev_active=True,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None):
        """(memory, memory_mask) for the decode; the previous sentence
        conditions it only when ``prev_active`` (a bool, or a 0/1 tensor
        in the concat mode). ``cfg.prev_mode`` "concat" appends the
        previous note embeddings to the encoder rows, their mask
        (non-pad ids) gated by ``prev_active``."""
        if self.cfg.prev_mode == "concat":
            enc = self.encode(src, src_mask, deterministic, generator)
            prev = self.tgt_embed(previous_ids, deterministic, generator)
            prev_mask = (previous_ids != 0).to(src_mask.dtype) * prev_active
            return (torch.cat([enc, prev], dim=1),
                    torch.cat([src_mask, prev_mask[:, None, None, :]],
                              dim=-1))
        if prev_active:
            return self.dot_attention_memory(src, src_mask, previous_ids,
                                             deterministic,
                                             generator), src_mask
        return self.encode(src, src_mask, deterministic, generator), src_mask

    def decode(self, memory, src_mask, tgt, tgt_mask,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        return self.decoder(self.tgt_embed(tgt, deterministic, generator),
                            memory, src_mask, tgt_mask, deterministic,
                            generator)

    def logits(self, decoder_out):
        return F.log_softmax(self.generator(decoder_out), dim=-1)

    def forward(self, src, tgt, src_mask, tgt_mask,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        memory = self.encode(src, src_mask, deterministic, generator)
        return self.logits(self.decode(memory, src_mask, tgt, tgt_mask,
                                       deterministic, generator))


class MSEDurationModel(nn.Module):
    """Encoder + Linear/LeakyReLU + scalar head regressing log-duration."""

    def __init__(self, cfg: MelodyConfig):
        super().__init__()
        self.src_embed = TokenEmbedding(cfg.src_vocab, cfg.d_model,
                                        cfg.dropout)
        self.encoder = MelodyEncoder(cfg)
        self.decoder = _dense(cfg.d_model, cfg.d_model)
        self.generator = _dense(cfg.d_model, 1)
        # the head regresses log(1 + centiseconds): start near a sung
        # syllable's 0.3 s, so an untrained pipeline still renders audible
        # notes instead of ~0 s phones with no frames
        nn.init.constant_(self.generator.bias, math.log1p(30.0))

    def forward(self, src, src_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = self.encoder(self.src_embed(src, deterministic, generator),
                         src_mask, deterministic, generator)
        x = F.leaky_relu(self.decoder(x), 0.2)
        return self.generator(x)[..., 0]  # [B, T] log-durations


@dataclasses.dataclass(frozen=True)
class SDPDurationConfig:
    src_vocab: int = 4000
    hidden_dim: int = 256
    n_layers: int = 6
    n_heads: int = 8
    pf_dim: int = 512
    dropout: float = 0.1
    max_len: int = 100


class PostNormEncoder(nn.Module):
    """Post-norm encoder with learned positional embeddings
    (transformer_melody/modules.py:742-790 of the reference)."""

    def __init__(self, cfg: SDPDurationConfig):
        super().__init__()
        d, r = cfg.hidden_dim, cfg.dropout
        self.dropout_rate = r
        self.scale = math.sqrt(d)
        self.tok = nn.Embedding(cfg.src_vocab, d)
        self.pos = nn.Embedding(cfg.max_len, d)
        for emb in (self.tok, self.pos):
            nn.init.normal_(emb.weight, std=d ** -0.5)
        self.attn = nn.ModuleList(MHA(d, cfg.n_heads, r)
                                  for _ in range(cfg.n_layers))
        self.norm1 = nn.ModuleList(nn.LayerNorm(d, eps=LN_EPS)
                                   for _ in range(cfg.n_layers))
        self.ff = nn.ModuleList(FeedForward(d, cfg.pf_dim, r)
                                for _ in range(cfg.n_layers))
        self.norm2 = nn.ModuleList(nn.LayerNorm(d, eps=LN_EPS)
                                   for _ in range(cfg.n_layers))

    def forward(self, src, src_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        kw = {"deterministic": deterministic, "generator": generator}
        r = self.dropout_rate
        pos = torch.arange(src.shape[1], device=src.device)[None, :]
        x = dropout(self.tok(src) * self.scale + self.pos(pos), r, **kw)
        for attn, norm1, ff, norm2 in zip(self.attn, self.norm1, self.ff,
                                          self.norm2):
            x = norm1(x + dropout(attn(x, x, x, src_mask, **kw), r, **kw))
            x = norm2(x + dropout(ff(x, **kw), r, **kw))
        return x


class SDPDurationModel(nn.Module):
    """Lyric2Duration: the post-norm encoder and the stochastic duration
    predictor. ``nll`` builds the predictor's training half too (flow 0
    and the posterior), which ``forward`` runs; inference
    (``infer_duration``) needs neither."""

    def __init__(self, cfg: SDPDurationConfig, nll: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = PostNormEncoder(cfg)
        # the JAX SDPDurationModel's constant DDSConv dropout, 0.5
        self.dp = StochasticDurationPredictor(cfg.hidden_dim, 3, 0.5,
                                              nll=nll)

    def infer_duration(self, src: torch.Tensor, noise_scale: float = 1.0,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """src: [B, T] ids (0 = pad). Returns durations w [B, T]
        (exp(logw)). ``noise`` [B, T, 2] replaces the standard normal draw
        from ``generator``; it is scaled by ``noise_scale`` either way."""
        mask = src != 0
        h = self.encoder(src, mask[:, None, None, :].to(torch.int32))
        fmask = mask[..., None].to(h.dtype)
        if noise is None:
            noise = torch.randn((*src.shape, 2), generator=generator,
                                device=src.device, dtype=h.dtype)
        logw = self.dp(h, fmask, noise * noise_scale)
        return torch.exp(logw) * mask.to(h.dtype)

    def forward(self, src: torch.Tensor, durations: torch.Tensor,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                e_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The flow NLL [B] of ``durations`` [B, T] (centiseconds) given
        src [B, T], each item's divided by the batch's count of unpadded
        positions. Dropout is on by default, as in the JAX __call__.
        ``e_q`` [B, T, 2] is the posterior noise, else drawn from
        ``generator``."""
        mask = src != 0
        h = self.encoder(src, mask[:, None, None, :].to(torch.int32),
                         deterministic, generator)
        fmask = mask[..., None].to(h.dtype)
        nll = self.dp.nll(h, fmask, durations[..., None], deterministic,
                          generator, e_q)
        return nll / torch.sum(fmask)
