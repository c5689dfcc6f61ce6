"""The sequence trainer of the PyTorch port (train/seq.py) on the CPU.

The data half is the JAX package's code: its pair builders and the four
batchers are held against music_generation_tpu/train/seq.py array for
array, each side with its own package's vocabularies, on the toy data and
on a transcription file. Then the port alone: `python -m
music_generation_tpu_torch.train.seq --family all --tiny --steps 14`
trains every family to a falling loss, a checkpoint resumes, and a
trained melody_note + duration_mse pair exported by
tools/torch_export_trained_melody.py is served by load_pipeline with the
trained models' notes. TensorBoard is blocked (its import costs seconds);
checkpoints go to tmp_path and are removed.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from music_generation_tpu.models.lyrics import \
    default_tokenizer as j_default_tokenizer
from music_generation_tpu.models.melody import telemelody as j_tm
from music_generation_tpu.models.melody import vocab as j_vocab
from music_generation_tpu.models.melody.seq2seq_api import \
    default_langs as j_default_langs
from music_generation_tpu.train import seq as j_seq
from music_generation_tpu_torch.compat import load_pipeline
from music_generation_tpu_torch.frontend import load_lexicon
from music_generation_tpu_torch.models.lyrics import default_tokenizer
from music_generation_tpu_torch.models.melody import (
    default_langs, lyric_dictionary_from_chars, note_dictionary)
from music_generation_tpu_torch.models.melody import telemelody as t_tm
from music_generation_tpu_torch.pipeline.synthesis import \
    build_melody_generator
from music_generation_tpu_torch.train import seq as t_seq

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_export_trained_melody  # noqa: E402

# syllables with an initial, a zero-initial final (a1) and an SP rest
TRANSCRIPTIONS = (
    "u0|你啊好|n i3 a1 h ao3 SP|C4 C4 E4 D4 D4 rest|"
    "0.3 0.3 0.5 0.4 0.4 0.2|0.1 0.2 0.5 0.1 0.3 0.2\n"
    "u1|天世界|t ian1 sh i4 j ie4|G4 G4 A4 A4 rest rest|"
    "0.25 0.25 0.6 0.6 0.35 0.35|0.1 0.15 0.2 0.4 0.1 0.25\n"
    "u2|好人|h ao3 r en2|E4 E4 C4 C4|1.2 1.2 0.9 0.9|0.2 1.0 0.3 0.6\n")


@pytest.fixture(scope="module")
def transcriptions(tmp_path_factory):
    path = tmp_path_factory.mktemp("seq") / "transcriptions.txt"
    path.write_text(TRANSCRIPTIONS, encoding="utf-8")
    return str(path)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _equal_batches(jb, tb, n=2, bs=3):
    for _ in range(n):
        want, got = jb.batch(bs), tb.batch(bs)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pair_builders_match_jax(transcriptions):
    phones = "n i3 a1 h ao3 SP AP rest".split()
    assert t_seq._syllable_group_starts(phones) == \
        j_seq._syllable_group_starts(phones)
    for name, args in (("_toy_melody_pairs", (16, 6, 3)),
                       ("_toy_melody_pairs_prev", (16, 6, 3)),
                       ("_toy_lyric_lines", (12, 2)),
                       ("_melody_pairs_from_transcriptions",
                        (transcriptions,))):
        assert getattr(t_seq, name)(*args) == getattr(j_seq, name)(*args), name
    lines = t_seq._toy_lyric_lines(4) + ["，，唱", "月亮照亮我的心。x"]
    for line in lines:
        assert t_seq.lyric_grammar_check(line) == \
            j_seq.lyric_grammar_check(line)
    assert t_seq.LYRIC_WORDS == j_seq.LYRIC_WORDS


@pytest.mark.parametrize("source", ["toy", "toy_prev", "transcriptions"])
def test_melody_batcher_matches_jax(source, transcriptions):
    chars = sorted(load_lexicon().monosyllable.keys())
    pairs = {"toy": lambda m: m._toy_melody_pairs(),
             "toy_prev": lambda m: m._toy_melody_pairs_prev(),
             "transcriptions": lambda m: m._melody_pairs_from_transcriptions(
                 transcriptions)}[source]
    jb = j_seq._MelodyBatcher(pairs(j_seq),
                              j_vocab.lyric_dictionary_from_chars(chars),
                              j_vocab.note_dictionary(), seed=1)
    tb = t_seq._MelodyBatcher(pairs(t_seq), lyric_dictionary_from_chars(chars),
                              note_dictionary(), seed=1)
    _equal_batches(jb, tb)


@pytest.mark.parametrize("source", ["toy", "transcriptions"])
def test_seq2seq_batcher_matches_jax(source, transcriptions):
    def pairs(m):
        return (m._toy_melody_pairs(n=32) if source == "toy" else
                m._melody_pairs_from_transcriptions(transcriptions))
    _equal_batches(j_seq._Seq2SeqBatcher(pairs(j_seq), j_default_langs(), 2),
                   t_seq._Seq2SeqBatcher(pairs(t_seq), default_langs(), 2))


def _telemelody_vocabs(m):
    """The dictionaries a TeleMelodyGenerator holds, without its models."""
    chars = sorted(load_lexicon().monosyllable.keys())
    return types.SimpleNamespace(
        lyric_dict=m.MelodyDictionary((m.SEP, m.WORD) + tuple(chars)),
        rhythm_dict=m.rhythm_vocab(), trend_dict=m.trend_vocab(),
        notes_dict=m.notes_vocab())


@pytest.mark.parametrize("source", ["toy", "transcriptions"])
def test_telemelody_batcher_matches_jax(source, transcriptions):
    def batcher(m, tm):
        if source == "toy":
            return m._TeleMelodyBatcher(_telemelody_vocabs(tm), seed=3)
        return m._TeleMelodyBatcher(
            _telemelody_vocabs(tm), t_len=48, seed=3,
            pairs=m._telemelody_pairs_from_transcriptions(transcriptions))
    _equal_batches(batcher(j_seq, j_tm), batcher(t_seq, t_tm))


@pytest.mark.parametrize("family", ["gpt2", "t5"])
def test_lyric_batcher_matches_jax(family):
    """Serving layouts; a keyword of 11 characters makes the T5 source
    longer than 16 tokens, so its EOS is cut off as in the JAX package
    (train/seq.py:524-525, recorded in ROADMAP.md Queue 3)."""
    lines = j_seq._toy_lyric_lines(8)
    keywords = ["夏天"] * 7 + ["月亮星星少年夏天清风大"]
    jb = j_seq._LyricBatcher(lines, j_default_tokenizer(family, tiny=True),
                             seed=4, family=family, keywords=keywords)
    tb = t_seq._LyricBatcher(lines, default_tokenizer(family, tiny=True),
                             seed=4, family=family, keywords=keywords)
    _equal_batches(jb, tb, n=3, bs=8)


def _first_last(out: str) -> dict:
    return {m.group(1): (float(m.group(2)), float(m.group(3))) for m in
            re.finditer(r"\[(\w+)\] first ([-\d.]+) -> last ([-\d.]+)", out)}


def test_cli_trains_every_family_on_cpu(capsys):
    """The whole sweep, as `--family all --tiny --steps 14 --device cpu`:
    every family's loss falls."""
    t_seq.main(["--family", "all", "--tiny", "--steps", "14", "--device",
                "cpu", "--log-every", "100"])
    runs = _first_last(capsys.readouterr().out)
    assert sorted(runs) == sorted(t_seq.FAMILIES)
    for fam, (first, last) in runs.items():
        assert np.isfinite(last) and last < first, (fam, first, last)


def test_checkpoint_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    t_seq.main(["--family", "duration_sdp", "--tiny", "--steps", "2",
                "--device", "cpu", "--ckpt-dir", ck, "--log-every", "1"])
    first = os.path.join(ck, "duration_sdp", "step_2.pt")
    saved = torch.load(first, weights_only=True)
    assert saved["step"] == 2 and saved["opt_state"]["state"]
    losses, model = t_seq.train_family(
        "duration_sdp", steps=1, tiny=True, ckpt_dir=ck, resume=first,
        device="cpu", return_model=True)
    assert "resumed duration_sdp" in capsys.readouterr().out
    resumed = torch.load(os.path.join(ck, "duration_sdp", "step_3.pt"),
                         weights_only=True)
    assert resumed["step"] == 3 and len(losses) == 1
    # one more AdamW step from the restored moments moved every leaf
    for k, v in model.state_dict().items():
        assert torch.equal(resumed["params"][k], v)
    assert any(not torch.equal(saved["params"][k], v)
               for k, v in resumed["params"].items())
    with open(os.path.join(ck, "logs", "train_metrics.jsonl")) as fh:
        assert len(fh.readlines()) == 2
    shutil.rmtree(ck)


def test_exported_melody_is_served(tmp_path):
    """melody_note and duration_mse trained 2 steps, exported, loaded by
    load_pipeline into the tiny served melody generator: the served notes
    and durations for a text equal those of the trained modules."""
    ck, served = str(tmp_path / "ck"), str(tmp_path / "served")
    trained = {fam: t_seq.train_family(fam, steps=2, tiny=True, ckpt_dir=ck,
                                       device="cpu", return_model=True)[1]
               for fam in ("melody_note", "duration_mse")}
    torch_export_trained_melody.main([
        "--notes", os.path.join(ck, "melody_note", "step_2.pt"),
        "--duration", os.path.join(ck, "duration_mse", "step_2.pt"),
        "--out", served])
    gen = build_melody_generator(tiny=True, seed=7, device="cpu")
    song = types.SimpleNamespace(synthesizers={}, melody=gen)
    assert load_pipeline(served, song) == ["melody_notes.pt",
                                           "melody_duration.pt"]
    direct = build_melody_generator(tiny=True, seed=8, device="cpu")
    direct.note_model = trained["melody_note"].eval()
    direct.duration_model = trained["duration_mse"].eval()
    for a, b in zip(gen.note_model.state_dict().values(),
                    direct.note_model.state_dict().values()):
        assert torch.equal(a, b)
    text = "你好世界天"
    assert gen.generate(text) == direct.generate(text)
    with pytest.raises(SystemExit):  # not a train.seq checkpoint
        torch.save({"gen": {}}, os.path.join(ck, "x.pt"))
        torch_export_trained_melody.main([
            "--notes", os.path.join(ck, "x.pt"), "--duration",
            os.path.join(ck, "x.pt"), "--out", served])
    shutil.rmtree(ck)
    shutil.rmtree(served)
