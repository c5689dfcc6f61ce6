"""Sequence-model training objectives and their step (melody transformer,
seq2seq RNNs, TeleMelody twins, duration heads, lyric LMs).

Twin of music_generation_tpu/train/seq_losses.py: label-smoothed CE for
the lyric->note enc-dec, plain CE for the LMs, MSE in log-duration space
for the MSE duration head, the SDP's flow NLL for the flow duration head.
A loss takes (model, batch of tensors, generator): the generator draws the
dropout masks (and the SDP's posterior noise) where the JAX losses take a
dropout rng; the LM losses run their models deterministically, as the JAX
ones do. The optimizer is optax.chain(clip_by_global_norm(5.0),
adamw(lr)) around torch's fused AdamW (``SeqOptimizer``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.melody.transformer import causal_mask
from .trainer import clip_by_global_norm


def cross_entropy(logits, targets, pad_id: int = 0,
                  label_smoothing: float = 0.0):
    """logits [B, T, V] (log-probs or raw: softmax applied), targets
    [B, T]; the mean over non-pad targets of the (smoothed) NLL."""
    vocab = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0:
        # the one-hot mixed with the uniform: (1 - s) * nll + s * mean
        nll = nll * (1 - label_smoothing) \
            - logp.sum(-1) * (label_smoothing / vocab)
    mask = (targets != pad_id).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _src_attn(src):
    return (src != 0)[:, None, None, :].to(torch.int32)


def melody_note_loss(model, batch, generator=None):
    """Teacher-forced lyric->note loss. batch: src, tgt_in, tgt_out."""
    src, tgt_in = batch["src"], batch["tgt_in"]
    logits = model(src, tgt_in, _src_attn(src),
                   causal_mask(tgt_in.shape[1], src.device),
                   deterministic=False, generator=generator)
    return cross_entropy(logits, batch["tgt_out"], label_smoothing=0.1)


def melody_note_prev_loss(model, batch, generator=None):
    """Teacher-forced loss through the previous-sentence memory (the
    serving path for every sentence after the first)."""
    src, tgt_in = batch["src"], batch["tgt_in"]
    kw = {"deterministic": False, "generator": generator}
    memory, mem_mask = model.prev_memory(src, _src_attn(src), batch["prev"],
                                         True, **kw)
    out = model.decode(memory, mem_mask, tgt_in,
                       causal_mask(tgt_in.shape[1], src.device), **kw)
    return cross_entropy(model.logits(out), batch["tgt_out"],
                         label_smoothing=0.1)


def duration_mse_loss(model, batch, generator=None):
    """log-duration regression (MSE family): targets in centiseconds."""
    src = batch["src"]
    out = model(src, _src_attn(src), deterministic=False, generator=generator)
    target = torch.log1p(batch["durations_cs"].float())
    mask = (src != 0).float()
    return torch.sum(((out - target) ** 2) * mask) / torch.clamp(
        mask.sum(), min=1.0)


def duration_sdp_loss(model, batch, generator=None):
    """Flow NLL of the ground-truth durations under the stochastic
    duration predictor; ``batch["e_q"]``, when present, is its posterior
    noise."""
    nll = model(batch["src"], batch["durations_cs"].float(),
                generator=generator, e_q=batch.get("e_q"))
    return torch.sum(nll)


def lm_loss(model, batch, generator=None):
    """Causal LM loss for GPT-2: predict ids[t+1] from ids[<=t]."""
    ids = batch["ids"]
    return cross_entropy(model(ids[:, :-1]), ids[:, 1:],
                         pad_id=batch.get("pad_id", 0))


def t5_loss(model, batch, generator=None):
    """Seq2seq CE for the T5 lyric generator: (src, tgt), the decoder fed
    tgt shifted right (BOS = pad = 0)."""
    src, tgt = batch["src"], batch["tgt"]
    tgt_in = F.pad(tgt[:, :-1], (1, 0))
    logits = model(src, (src != 0).to(torch.int32), tgt_in)
    return cross_entropy(logits, tgt, pad_id=0)


def seq2seq_family_loss(models, batch, generator=None):
    """Joint CE over the three RNN models of the melody_v2 family
    (lyric2note, lyric2duration, note2duration), each teacher-forced
    through Seq2SeqModel.forward."""
    wiring = (("lyric2note", "lyric_src", "note_in", "note_out"),
              ("lyric2duration", "lyric_src", "dur_in", "dur_out"),
              ("note2duration", "note_src", "dur_in", "dur_out"))
    total = 0.0
    for name, s, ti, to in wiring:
        total = total + cross_entropy(models[name](batch[s], batch[ti]),
                                      batch[to])
    return total


def telemelody_family_loss(models, batch, generator=None):
    """Joint label-smoothed CE over TeleMelody's twin transformers
    (lyric2rhythm + trend2melody)."""
    total = 0.0
    for name in ("lyric2rhythm", "trend2melody"):
        src, tgt_in = batch[f"{name}_src"], batch[f"{name}_in"]
        logits = models[name](src, tgt_in, _src_attn(src),
                              causal_mask(tgt_in.shape[1], src.device),
                              deterministic=False, generator=generator)
        total = total + cross_entropy(logits, batch[f"{name}_out"],
                                      label_smoothing=0.1)
    return total


CLIP_NORM = 5.0  # train.seq's global-norm clip


class SeqOptimizer:
    """optax.chain(clip_by_global_norm(CLIP_NORM), adamw(lr)) updating
    ``params`` in place: the optax-form clip (scale by CLIP_NORM / norm
    only when norm >= CLIP_NORM), then torch's fused AdamW with optax
    adamw's defaults (betas 0.9/0.999, eps 1e-8 outside the sqrt, decoupled
    weight decay 1e-4 on every parameter)."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=1e-4,
                                       fused=True)

    @torch.no_grad()
    def update(self, grads) -> None:
        grads = clip_by_global_norm(list(grads), CLIP_NORM)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def make_seq_train_step(loss_fn, model, optimizer: SeqOptimizer):
    """step(batch, generator) -> the loss (a detached 0-dim tensor): one
    update of ``model``'s parameters (a module, or a dict of modules for
    the joint families) through ``optimizer``."""

    def step(batch: dict, generator: Optional[torch.Generator] = None):
        loss = loss_fn(model, batch, generator)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        optimizer.update([torch.zeros_like(p) if g is None else g
                          for p, g in zip(optimizer.params, grads)])
        return loss.detach()

    return step
