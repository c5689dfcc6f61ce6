"""Server variant presets: one config axis instead of five copied trees.

Twin of music_generation_tpu/serve/variants.py. The reference ships five
server/controller/pipeline copies (music_generation_server*.py); each
preset reproduces one:
  v1            pipeline-only controller (shell backend, mode heuristics)
  v1_model      TeleMelody MIDI with its rendered accompaniment
  melody_v2     T5 lyrics + seq2seq melody (+ canned demo responses)
  svs_v5        T5 lyrics + transformer melody w/ SDP durations
  svs_v5_ms     v5 + 3 speakers
  svs_v6_ms     T5 lyrics + transformer melody w/ MSE durations + 3 speakers
The port serves every preset; v1's shell backend is
pipeline/shell_backend.py in front of the default model path
(serve.app.MusicGenerationService.handle_synthesis).
"""

from __future__ import annotations

import base64
import os
import re
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class VariantSpec:
    name: str
    backend: str = "model"            # "model" | "shell"
    melody: str = "mse"               # "mse" | "sdp" | "seq2seq" | "telemelody"
    n_speakers: int = 1
    canned_dir: Optional[str] = None  # resources/ with canned demo songs
    accompaniment: bool = False       # mix rendered MIDI under the vocal
    # svs_v5's per-fragment phrase substitutions
    # (pipline_inference_svs_v5.py:191; v6 comments them out)
    censor_lyrics: bool = False


VARIANTS = {
    "v1": VariantSpec("v1", backend="shell"),
    # pipeline v1's model path: TeleMelody MIDI + 0.8*render mixed under the
    # vocal (pipline_inference.py:137-151,221-232)
    "v1_model": VariantSpec("v1_model", melody="telemelody",
                            accompaniment=True),
    "melody_v2": VariantSpec("melody_v2", melody="seq2seq",
                             canned_dir="./resources"),
    "svs_v5": VariantSpec("svs_v5", melody="sdp", censor_lyrics=True),
    "svs_v5_multispeaker": VariantSpec("svs_v5_multispeaker", melody="sdp",
                                       n_speakers=3, censor_lyrics=True),
    "svs_v6_multispeaker": VariantSpec("svs_v6_multispeaker", melody="mse",
                                       n_speakers=3),
}


def canned_response(keyword: str, canned_dir: Optional[str]):
    """Canned demo songs for specific keywords (parity:
    controllers_music_generation_melody_v2/syn_music.py:30-54)."""
    if not canned_dir:
        return None
    mapping = {"宁夏": ("宁夏.txt", "宁夏.wav"),
               "青春修炼手册": ("青春修炼手册.txt", "青春修炼手册.wav")}
    entry = mapping.get(keyword.strip())
    if not entry:
        return None
    txt_path = os.path.join(canned_dir, entry[0])
    wav_path = os.path.join(canned_dir, entry[1])
    if not (os.path.exists(txt_path) and os.path.exists(wav_path)):
        return None
    with open(txt_path, encoding="utf-8") as f:
        lyrics = f.read()
    with open(wav_path, "rb") as f:
        audio = base64.b64encode(f.read()).decode()
    return {"code": 200, "message": "success！",
            "data": {"lyrics": lyrics, "audio": audio}}


def build_melody_generator(spec: VariantSpec, tiny: bool = False,
                           seed: int = 0, device=None):
    """Melody generator for a variant (the pipeline dispatch axis), on
    ``device`` (default cuda)."""
    if spec.melody in ("mse", "sdp"):
        from ..pipeline.synthesis import build_melody_generator as build
        return build(tiny, seed, device, duration_variant=spec.melody)
    if spec.melody == "seq2seq":
        from ..models.melody import (Seq2SeqConfig, Seq2SeqMelodyGenerator,
                                     default_langs)
        cfg = (Seq2SeqConfig(en_embedding_dim=16, de_embedding_dim=16,
                             hidden_dim=16, num_layers=1) if tiny
               else Seq2SeqConfig())
        return _Seq2SeqAdapter(Seq2SeqMelodyGenerator(
            *default_langs(), cfg=cfg, seed=seed, device=device))
    if spec.melody == "telemelody":
        from ..models.melody import MelodyConfig, TeleMelodyGenerator
        cfg = (MelodyConfig(n_layers=1, d_model=32, d_ff=64, n_heads=2)
               if tiny else MelodyConfig())
        return _TeleMelodyAdapter(TeleMelodyGenerator(cfg=cfg, seed=seed,
                                                      device=device))
    raise ValueError(spec.melody)


def variant_song_synthesizer(spec: VariantSpec, synthesizers: dict,
                             tiny: bool = False, seed: int = 0, device=None):
    """The song pipeline a variant serves: its melody generator (from
    ``seed``), lyric substitutions and accompaniment around already built
    per-speaker SVS synthesizers."""
    from ..pipeline.synthesis import LYRIC_REPLACEMENTS, SongSynthesizer
    return SongSynthesizer(
        build_melody_generator(spec, tiny, seed, device), synthesizers,
        lyric_replacements=LYRIC_REPLACEMENTS if spec.censor_lyrics else (),
        mix_accompaniment=spec.accompaniment)


class _Seq2SeqAdapter:
    """Adapts Seq2SeqMelodyGenerator.get_melody to the MelodyGenerator
    .generate(sentence, index, previous_notes) surface of the pipeline."""

    def __init__(self, gen):
        self.gen = gen

    def generate(self, lyric, index=0, previous_notes=None):
        from ..frontend import note_to_midi
        lyrics_out, note_names, durations = self.gen.get_melody(lyric)
        tokens = [str(note_to_midi(n)) if n != "rest" else "rest"
                  for n in note_names]
        return lyrics_out, tokens, [float(d) for d in durations]


class _TeleMelodyAdapter:
    """Adapts TeleMelodyGenerator.get_melody to the pipeline's
    .generate(sentence, index, previous_notes) surface, keeping the
    sentence's MIDI tracks (melody + block-chord piano) in
    ``last_tracks`` for the accompaniment."""

    def __init__(self, gen):
        self.gen = gen
        self.last_tracks = None

    def generate(self, lyric, index=0, previous_notes=None):
        from ..frontend import note_to_midi
        result, durations, pitches = self.gen.get_melody(lyric)
        self.last_tracks = result.tracks
        tokens = [str(note_to_midi(p)) for p in pitches]
        # punctuation became [sep] (no note): drop it from the sung text so
        # that syllables and notes stay one to one for the score aligner
        clean = re.sub(r"[,.!，。！？?；;、]", "", lyric)
        return clean + "AP", tokens + ["rest"], durations + [0.6]
