"""Beam search for the melody enc-dec.

Twin of beam_search in music_generation_tpu/models/melody/beam.py: a dense
[beam, max_len + 1] token buffer, finished beams frozen to a zero-cost PAD,
only beam 0 expanded at the first step, one flat top-k over beam x vocab
per step. Ties break towards the lower flat index, as lax.top_k does: a
stable descending sort, which is deterministic on CUDA (torch.topk's order
there is not specified).
"""

from __future__ import annotations

from typing import Callable

import torch

NEG_INF = -1e9


def topk_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of 1-D x; equal values
    come in increasing index order."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def beam_search(decode_logits: Callable[[torch.Tensor, int], torch.Tensor],
                max_len: int, beam_size: int, bos_id: int, eos_id: int,
                pad_id: int = 0, device=None):
    """decode_logits(seqs [beam, max_len+1], step) -> log-probs [beam, V]
    for the token at position ``step + 1`` given seqs[:, :step + 1].

    Returns (best_seq [max_len] including trailing PADs, best_score)."""
    seqs = torch.full((beam_size, max_len + 1), pad_id, dtype=torch.int64,
                      device=device)
    seqs[:, 0] = bos_id
    scores = torch.zeros(beam_size, device=device)
    finished = torch.zeros(beam_size, dtype=torch.bool, device=device)
    frozen = None
    for step in range(max_len):
        logprobs = decode_logits(seqs, step)              # [beam, V]
        vocab = logprobs.shape[-1]
        if frozen is None:
            # built by a comparison: frozen[pad_id] = 0.0 would copy a host
            # scalar to the card and wait for it
            frozen = torch.where(
                torch.arange(vocab, device=device) == pad_id, 0.0, NEG_INF)
        logprobs = torch.where(finished[:, None], frozen[None, :], logprobs)
        combined = scores[:, None] + logprobs
        if step == 0:  # all beams share the BOS state: expand beam 0 only
            combined[1:] = NEG_INF
        scores, top_idx = topk_lower_index(combined.reshape(-1), beam_size)
        src_beam = top_idx // vocab
        token = top_idx % vocab
        seqs = seqs[src_beam]
        seqs[:, step + 1] = token
        finished = finished[src_beam] | (token == eos_id)
    # index_select, not seqs[best]: indexing by a 0-dim tensor reads it on
    # the host
    best = torch.argmax(scores).view(1)
    return seqs.index_select(0, best)[0, 1:], scores.index_select(0, best)[0]
