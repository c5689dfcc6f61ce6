"""Lyric LMs of the port: T5 (served by default) and GPT-2, their
tokenizers and generators."""
from .api import (LyricGeneratorGPT2, LyricGeneratorT5, build_lyric_generator,
                  default_tokenizer, find_vocab_artifact, t5_config_for)
from .gpt2 import GPT2, GPT2Config, greedy_generate, init_cache
from .spm import SentencePieceUnigram, T5SentencePieceTokenizer
from .t5 import T5, T5Config, init_t5_cache, topk_sample_generate
from .tokenizer import STYLE_TOKENS, CharTokenizer
from .wordpiece import WordPieceTokenizer

__all__ = [
    "LyricGeneratorGPT2", "LyricGeneratorT5", "GPT2", "GPT2Config",
    "greedy_generate", "init_cache", "T5", "T5Config", "topk_sample_generate",
    "init_t5_cache", "CharTokenizer", "STYLE_TOKENS", "WordPieceTokenizer",
    "SentencePieceUnigram", "T5SentencePieceTokenizer", "default_tokenizer",
    "find_vocab_artifact", "t5_config_for", "build_lyric_generator",
]
