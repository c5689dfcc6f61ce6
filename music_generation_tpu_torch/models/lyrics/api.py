"""Host-level lyric generation API.

Twin of music_generation_tpu/models/lyrics/api.py. Parity surfaces:
  - GPT-2: Lyric_generator/generator.py:23-51 — prompt
    "[CLS] title [SEP] <style> [SEP]", greedy w/ bigram ban, post-split on
    <结束> then join [SEP] segments with '，'.
  - T5: Lyric_generator_t5/generator.py:21-35 — prompt
    "关键词：{kw} 长度：15", top-k 10 sampling.
Both generators run on ``device`` (default cuda) and draw their random
init (and, for T5, the sampling noise) from ``seed``.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .gpt2 import GPT2, GPT2Config, greedy_generate
from .spm import T5SentencePieceTokenizer
from .t5 import T5, T5Config, topk_sample_generate
from .tokenizer import EOS, SEP, CharTokenizer
from .wordpiece import WordPieceTokenizer

GPT2_MAX_LENGTH = 90
T5_MAX_LENGTH = 512  # Lyric_generator_t5/generator.py:33 max_length=512
T5_TOP_K = 10

# Vocabulary artifacts for the reference checkpoints (BERT wordpiece
# vocab.txt for GPT-2, sentencepiece spiece.model for T5). Resolution order:
# $MUSIC_GEN_VOCAB_DIR, checkpoints/vocab under the launch directory or the
# repository root, then the reference snapshot under
# $MUSIC_GEN_REFERENCE_DIR. Falls back to the self-contained CharTokenizer
# when no artifact is found.
_VOCAB_FILES = {"gpt2": "vocab.txt", "t5": "spiece.model"}
_REF_PATHS = {
    "gpt2": "Lyric_generator/checkpoint/vocab.txt",
    "t5": "Lyric_generator_t5/checkpoint/spiece.model",
}


def find_vocab_artifact(family: str) -> Optional[str]:
    candidates = []
    env = os.environ.get("MUSIC_GEN_VOCAB_DIR")
    if env:
        candidates.append(os.path.join(env, _VOCAB_FILES[family]))
    # both the launch cwd and the repository root:
    # cwd-only resolution would silently swap the tokenizer — and hence the
    # model's vocab size — based on where the process was started
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for base in (os.getcwd(), repo_root):
        candidates.append(os.path.join(base, "checkpoints", "vocab",
                                       _VOCAB_FILES[family]))
    ref = os.environ.get("MUSIC_GEN_REFERENCE_DIR")
    if ref:
        candidates.append(os.path.join(ref, _REF_PATHS[family]))
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def default_tokenizer(family: str = "t5", tiny: bool = False):
    """Reference-compatible tokenizer when its vocab artifact is available
    (vocab 21136 GPT-2 / 32128 T5); CharTokenizer otherwise or for tiny
    builds (small vocab keeps tiny-model embeds small)."""
    path = None if tiny else find_vocab_artifact(family)
    if path is None:
        return CharTokenizer()
    if family == "gpt2":
        return WordPieceTokenizer(path)
    return T5SentencePieceTokenizer(path)


def t5_config_for(tokenizer, **overrides) -> T5Config:
    """T5Config with the special-token ids taken from the tokenizer.

    The HF defaults (pad=0, eos=1) only hold for the sentencepiece vocab;
    the CharTokenizer puts <结束> at id 4 and [CLS] at id 1 — with the
    default eos the sampler can never terminate (it waits for a token the
    training targets never contain) and every generation runs the full
    token budget into degeneracy."""
    return T5Config(vocab_size=tokenizer.vocab_size,
                    eos_token_id=tokenizer.eos_id,
                    pad_token_id=tokenizer.pad_id,
                    decoder_start_token_id=tokenizer.pad_id,
                    **overrides)


class LyricGeneratorGPT2:
    def __init__(self, cfg: Optional[GPT2Config] = None, tokenizer=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or default_tokenizer("gpt2")
        self.cfg = cfg or GPT2Config(vocab_size=self.tokenizer.vocab_size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = GPT2(self.cfg)
        self.model.to(self.device).eval()

    def generate(self, title: str, style: str = "<Pop 流行>") -> str:
        tok = self.tokenizer
        prompt = ([tok.cls_id] + tok.encode(title) + [tok.sep_id]
                  + [tok.token_id(style)] + [tok.sep_id])
        buf = np.full((1, GPT2_MAX_LENGTH), tok.pad_id, np.int64)
        buf[0, : len(prompt)] = prompt
        tokens = greedy_generate(self.model,
                                 torch.from_numpy(buf).to(self.device),
                                 torch.tensor([len(prompt)]),
                                 max_length=GPT2_MAX_LENGTH)
        text = tok.decode(tokens[0].cpu().tolist())
        # reference post-processing: cut at <结束>, drop the prompt segments,
        # join the remaining [SEP] segments with '，'
        text = text.split(EOS)[0]
        segs = text.split(SEP)
        return "，".join(segs[2:-1]).replace(" ", "").replace("[PAD]", "")


class LyricGeneratorT5:
    TITLE_PROMPT = "关键词："
    LENGTH_PROMPT = "长度："

    def __init__(self, cfg: Optional[T5Config] = None, tokenizer=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or default_tokenizer("t5")
        self.cfg = cfg or t5_config_for(self.tokenizer)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = T5(self.cfg)
        self.model.to(self.device).eval()
        # the JAX twin's PRNG key: one stream of sampling noise per
        # generator, on its device; concurrent requests take turns on it
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(seed + 1)
        self._lock = threading.Lock()

    def prompt_ids(self, keyword: str, length: int = 15) -> list[int]:
        tok = self.tokenizer
        prompt = f"{self.TITLE_PROMPT}{keyword} {self.LENGTH_PROMPT}{length}"
        # reference T5Tokenizer appends </s> (add_special_tokens=True)
        return tok.encode(prompt, add_eos=True)

    def generate(self, keyword: str, length: int = 15,
                 max_length: Optional[int] = None) -> str:
        """keyword -> lyrics. `length` goes into the prompt (reference
        convention); the DECODE budget is `max_length` tokens — by default
        scaled off `length` rather than the flat 512 of the reference so a
        model that under-learned EOS still can't emit a 500-char wall."""
        if max_length is None:
            max_length = min(T5_MAX_LENGTH, max(48, 8 * length))
        src = torch.tensor([self.prompt_ids(keyword, length)],
                           device=self.device)
        with self._lock:
            out = topk_sample_generate(self.model, self.generator, src,
                                       torch.ones_like(src),
                                       max_length=max_length,
                                       top_k=T5_TOP_K)
        ids_out = out[0].cpu().tolist()
        if self.cfg.eos_token_id in ids_out:
            ids_out = ids_out[: ids_out.index(self.cfg.eos_token_id)]
        ids_out = [i for i in ids_out if i != self.cfg.pad_token_id]
        return self.tokenizer.decode(ids_out, skip_special=True)


def build_lyric_generator(family: str = "t5", tiny: bool = False,
                          seed: int = 0, device=None):
    """The served lyric LM: random-init ``family`` (t5 | gpt2) at its
    published widths, or the JAX server's tiny widths under ``tiny``, over
    default_tokenizer(family). T5 takes its special ids from the tokenizer
    (t5_config_for), where the JAX server keeps T5Config's defaults."""
    tok = default_tokenizer(family, tiny=tiny)
    if family == "gpt2":
        cfg = (GPT2Config(vocab_size=tok.vocab_size, n_layer=1, n_embd=32,
                          n_head=2, n_positions=128) if tiny
               else GPT2Config(vocab_size=tok.vocab_size))
        return LyricGeneratorGPT2(cfg, tokenizer=tok, seed=seed,
                                  device=device)
    if family != "t5":
        raise ValueError(f"unknown lyric model {family!r}")
    cfg = (t5_config_for(tok, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                         num_decoder_layers=1, num_heads=4) if tiny
           else t5_config_for(tok))
    return LyricGeneratorT5(cfg, tokenizer=tok, seed=seed, device=device)
