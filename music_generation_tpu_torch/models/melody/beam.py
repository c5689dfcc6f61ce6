"""Beam search and top-k sampling for the melody enc-decs.

Twin of music_generation_tpu/models/melody/beam.py. beam_search: a dense
[beam, max_len + 1] token buffer, finished beams frozen to a zero-cost PAD,
only beam 0 expanded at the first step, one flat top-k over beam x vocab
per step. sample_decode: TeleMelody's top-k temperature sampling, one
Gumbel-max draw among the top k per step. Ties break towards the lower
index, as lax.top_k does: a stable descending sort, which is deterministic
on CUDA (torch.topk's order there is not specified). Both are host loops
over steps that never read the device inside the loop.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def gumbel(shape, generator: Optional[torch.Generator] = None,
           device=None) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1),
    as jax.random.gumbel computes them."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_decode(decode_logits: Callable[[torch.Tensor, int], torch.Tensor],
                  max_len: int, bos_id: int, eos_id: int, pad_id: int = 0,
                  top_k: int = 10, temperature: float = 1.0,
                  min_len: int = 0,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  device=None) -> torch.Tensor:
    """Top-k temperature sampling of one sequence (the decode of the
    TeleMelody models). decode_logits(tokens [1, max_len + 1], step) ->
    log-probs [1, V] for the token at position ``step + 1``. Each step
    divides them by ``temperature``, forbids EOS before ``min_len``, keeps
    the top ``top_k`` and picks argmax(values + Gumbel noise), which is
    jax.random.categorical's draw; after EOS the tokens are PAD. ``noise``
    [max_len, top_k] gives the Gumbel draws (else they come from
    ``generator``). Returns tokens [max_len] on the device."""
    if noise is None:
        noise = gumbel((max_len, top_k), generator, device)
    noise = noise.to(device)
    tokens = torch.full((1, max_len + 1), pad_id, dtype=torch.int64,
                        device=device)
    tokens[0, 0] = bos_id
    finished = torch.zeros((), dtype=torch.bool, device=device)
    eos_mask = None
    for step in range(max_len):
        logprobs = decode_logits(tokens, step)[0] / temperature
        if step < min_len:
            if eos_mask is None:
                eos_mask = torch.arange(logprobs.shape[-1],
                                        device=device) == eos_id
            logprobs = torch.where(eos_mask, NEG_INF, logprobs)
        vals, idx = topk_lower_index(logprobs, top_k)
        choice = torch.argmax(vals + noise[step]).view(1)
        # a gather, not idx[choice]: no host read of the choice
        nxt = torch.where(finished, pad_id, idx.gather(0, choice)[0])
        finished = finished | (nxt == eos_id)
        tokens[0, step + 1] = nxt
    return tokens[0, 1:]
