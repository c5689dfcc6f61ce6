"""Seq2seq RNN melody models (the reference's "melody_v2" family).

Twin of music_generation_tpu/models/melody/seq2seq.py: a GRU (or LSTM)
encoder, bidirectional, honouring each source's length (the reverse
direction starts at the sequence's own last token), and a single-step
attention decoder (a cell stack, dot attention masked to the source
length, tanh(linear1), linear2, log_softmax), plus the beam-5 decode.

Vocab layout as utils/profile.py Lang of the reference: _PAD_=0 _UNK_=1
_EOS_=2 _START_=3.

Cell layouts: flax's GRUCell is torch's GRU with no hidden bias on the
reset and update gates; flax's LSTMCell is torch's LSTM with no input
bias. Those torch biases start at zero here, so the port's random models
stay inside the family the JAX package can express. An LSTM's carry is
(c, h) in flax: the encoder hands on the final CELL state c, and the
decoder starts from c = that state, h = 0, as the JAX twin does.

The beam decode is a host loop of fixed length (finished beams frozen to a
zero-cost PAD), with no host wait inside it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .beam import topk_lower_index

PAD_ID, UNK_ID, EOS_ID, START_ID = 0, 1, 2, 3
NEG_INF = -1e9


class Lang:
    """Token vocabulary (parity: utils/profile.py:7-25)."""

    def __init__(self, items=()):
        self.item2index = {"_PAD_": 0, "_UNK_": 1, "_EOS_": 2, "_START_": 3}
        self.index2item = {0: "_PAD_", 1: "_UNK_", 2: "_EOS_", 3: "_START_"}
        for it in items:
            self.add(str(it))

    def add(self, item: str):
        if item not in self.item2index:
            idx = len(self.item2index)
            self.item2index[item] = idx
            self.index2item[idx] = item

    @property
    def n_items(self):
        return len(self.item2index)

    def encode(self, tokens) -> list[int]:
        return [self.item2index.get(str(t), UNK_ID) for t in tokens]

    def decode(self, ids) -> list[str]:
        return [self.index2item.get(int(i), "_UNK_") for i in ids]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    en_vocab: int = 4000
    de_vocab: int = 40
    en_embedding_dim: int = 256
    de_embedding_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 1
    use_lstm: bool = False


def _embedding(vocab: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(vocab, dim)
    nn.init.uniform_(emb.weight, 0.0, 0.1)  # flax uniform(scale=0.1)
    return emb


def _zero_missing_biases(rnn: nn.Module, use_lstm: bool, hidden: int):
    """Zero the torch biases flax's cells lack: the GRU's hidden bias of
    the r and z gates, every input bias of the LSTM."""
    with torch.no_grad():
        for name, p in rnn.named_parameters():
            if name.startswith("bias_hh") and not use_lstm:
                p[: 2 * hidden] = 0.0
            elif name.startswith("bias_ih") and use_lstm:
                p.zero_()


class Seq2SeqEncoder(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = _embedding(cfg.en_vocab, cfg.en_embedding_dim)
        rnn = nn.LSTM if cfg.use_lstm else nn.GRU
        self.rnn = rnn(cfg.en_embedding_dim, cfg.hidden_dim,
                       num_layers=cfg.num_layers,
                       bidirectional=True, batch_first=True)
        _zero_missing_biases(self.rnn, cfg.use_lstm, cfg.hidden_dim)

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor):
        """ids [B, T], lengths [B] -> (outputs [B, T, 2H], zero past each
        length; final carry [B, 2H] of the last layer, forward then
        backward: h for a GRU, the cell state c for an LSTM)."""
        packed = pack_padded_sequence(self.embed(ids), lengths.cpu(),
                                      batch_first=True, enforce_sorted=False)
        out, state = self.rnn(packed)
        out, _ = pad_packed_sequence(out, batch_first=True,
                                     total_length=ids.shape[1])
        final = state[1] if self.cfg.use_lstm else state
        return out, torch.cat(list(final[-2:]), dim=-1)


class Seq2SeqDecoder(nn.Module):
    """Single-step attention decoder, driven by a loop outside it."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        h = 2 * cfg.hidden_dim  # the bidirectional encoder's width
        self.embed = _embedding(cfg.de_vocab, cfg.de_embedding_dim)
        cell = nn.LSTMCell if cfg.use_lstm else nn.GRUCell
        self.cell = nn.ModuleList(
            cell(cfg.de_embedding_dim if i == 0 else h, h)
            for i in range(cfg.num_layers))
        for c in self.cell:
            _zero_missing_biases(c, cfg.use_lstm, h)
        self.linear1 = nn.Linear(2 * h, h)
        self.linear2 = nn.Linear(h, cfg.de_vocab)

    def step(self, token: torch.Tensor, encoder_output: torch.Tensor,
             state: list, enc_mask: Optional[torch.Tensor] = None):
        """token [B]; state: one carry per layer ([B, H], or (h, c) for
        an LSTM). enc_mask: [B, S] 1/0 over encoder positions. Returns
        (logprobs [B, V], state)."""
        x = self.embed(token)
        new_state = []
        for cell, carry in zip(self.cell, state):
            carry = cell(x, carry)
            x = carry[0] if self.cfg.use_lstm else carry
            new_state.append(carry)
        scores = torch.einsum("bh,bsh->bs", x, encoder_output)
        if enc_mask is not None:
            scores = torch.where(enc_mask > 0, scores,
                                 torch.full_like(scores, NEG_INF))
        ctx = torch.einsum("bs,bsh->bh", torch.softmax(scores, dim=-1),
                           encoder_output)
        combine = torch.tanh(self.linear1(torch.cat([x, ctx], dim=-1)))
        return F.log_softmax(self.linear2(combine), dim=-1), new_state

    def init_state(self, encoder_hidden: torch.Tensor) -> list:
        """Initial decoder carries from the encoder's final carry."""
        if self.cfg.use_lstm:
            return [(torch.zeros_like(encoder_hidden), encoder_hidden)
                    for _ in range(self.cfg.num_layers)]
        return [encoder_hidden for _ in range(self.cfg.num_layers)]


def _encoder_inputs(src_ids: torch.Tensor):
    """(lengths [B], enc_mask [B, S]) of right-padded sources; an empty
    source counts one position."""
    lengths = (src_ids != PAD_ID).sum(dim=1).clamp(min=1)
    pos = torch.arange(src_ids.shape[1], device=src_ids.device)
    return lengths, (pos[None, :] < lengths[:, None]).to(torch.int32)


class Seq2SeqModel(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Seq2SeqEncoder(cfg)
        self.decoder = Seq2SeqDecoder(cfg)

    def encode(self, ids, lengths=None):
        """(outputs, final carry) of ids [B, T]; without ``lengths`` every
        row runs to T, as flax's RNN without seq_lengths."""
        if lengths is None:
            lengths = torch.full((ids.shape[0],), ids.shape[1])
        return self.encoder(ids, lengths)

    def decode_step(self, token, encoder_output, state, enc_mask=None):
        return self.decoder.step(token, encoder_output, state, enc_mask)

    def init_decoder_state(self, encoder_hidden):
        return self.decoder.init_state(encoder_hidden)

    def forward(self, src_ids: torch.Tensor, tgt_ids: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced forward -> logprobs [B, T_tgt, V], with the same
        length-masked encode and enc_mask as beam_decode."""
        lengths, enc_mask = _encoder_inputs(src_ids)
        enc_out, enc_hidden = self.encoder(src_ids, lengths)
        state = self.decoder.init_state(enc_hidden)
        outs = []
        for t in range(tgt_ids.shape[1]):
            lp, state = self.decoder.step(tgt_ids[:, t], enc_out, state,
                                          enc_mask)
            outs.append(lp)
        return torch.stack(outs, dim=1)


@torch.no_grad()
def beam_decode(model: Seq2SeqModel, src_ids: torch.Tensor, max_len: int,
                beam: int = 5):
    """Beam search carrying the RNN state per beam. src_ids: [1, T] (0 =
    PAD, right-padding masked through the length). Returns (seq [max_len],
    score). Only beam 0 is expanded at the first step; top-k ties go to
    the lower flat index, as lax.top_k breaks them."""
    device = src_ids.device
    lengths, enc_mask = _encoder_inputs(src_ids)
    enc_out, enc_hidden = model.encoder(src_ids, lengths)
    enc_out = enc_out.repeat_interleave(beam, dim=0)
    enc_mask = enc_mask.repeat_interleave(beam, dim=0)
    state = model.decoder.init_state(enc_hidden.repeat_interleave(beam, 0))

    seqs = torch.full((beam, max_len + 1), PAD_ID, dtype=torch.int64,
                      device=device)
    seqs[:, 0] = START_ID
    scores = torch.zeros(beam, device=device)
    finished = torch.zeros(beam, dtype=torch.bool, device=device)
    frozen = torch.full((model.cfg.de_vocab,), NEG_INF, device=device)
    frozen[PAD_ID] = 0.0
    for step in range(max_len):
        logprobs, state = model.decoder.step(seqs[:, step], enc_out, state,
                                             enc_mask)
        vocab = logprobs.shape[-1]
        logprobs = torch.where(finished[:, None], frozen[None, :], logprobs)
        combined = scores[:, None] + logprobs
        if step == 0:  # all beams share the START state
            combined[1:] = NEG_INF
        scores, top_idx = topk_lower_index(combined.reshape(-1), beam)
        src_beam = top_idx // vocab
        token = top_idx % vocab
        seqs = seqs[src_beam]
        seqs[:, step + 1] = token
        finished = finished[src_beam] | (token == EOS_ID)
        state = [tuple(s[src_beam] for s in c) if isinstance(c, tuple)
                 else c[src_beam] for c in state]
    best = torch.argmax(scores)
    return seqs[best, 1:], scores[best]
