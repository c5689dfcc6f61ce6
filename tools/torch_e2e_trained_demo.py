#!/usr/bin/env python3
"""End-to-end trained-system demo on the port: train the pipeline's stages
from scratch on the synthetic toy corpus (train.seq), serve the trained
weights, synthesize a song and measure quality probes.

Twin of tools/e2e_trained_demo.py, section for section:

  melody_note       the tiny note transformer on the toy char -> note law:
                    held-out teacher-forced note accuracy
  melody_note_prev  previous-sentence conditioning (>= 1000 steps):
                    teacher-forced, position-0 and free-running accuracy
                    with the true and a shuffled previous sentence
  seq2seq           the melody_v2 RNN family (>= 800 steps) served through
                    Seq2SeqMelodyGenerator.get_melody on 16 held-out lines
  duration_mse      the MSE duration head
  full              duration_sdp and telemelody at full width (<= 300
                    steps), the last ten losses under 0.9 of the first ten
  e2e               the trained note and duration models written as a
                    pipeline directory and served: serve.app's --tiny
                    song pipeline with --checkpoint-dir sings the demo
                    lyrics; its notes against the toy mapping
  lm                tiny T5 and GPT-2 (>= 1200 steps): corpus perplexity
                    trained vs random init, then keyword -> trained T5
                    lyrics (best of 12 samples) -> song, with the JAX tool's
                    grammar and degeneracy checks

Same flags, sections and JSON keys as the JAX tool, with ``--device``
(default cuda) in place of ``--tpu``; the JSON is written only where
``--out`` says (``--only`` then keeps the other sections of an existing
file).

Usage:
  python tools/torch_e2e_trained_demo.py [--steps 400] [--only e2e] \
      [--out artifacts/torch_e2e_trained_demo.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_SECTIONS = ("melody_note", "melody_note_prev", "seq2seq", "duration_mse",
             "full", "e2e", "lm")
# sections that reuse another section's trained models
_DEPS = {"e2e": {"melody_note", "duration_mse"},
         "lm": {"e2e", "melody_note", "duration_mse"}}


def wanted_sections(only: str | None) -> set:
    """The sections to run for ``--only`` (with their dependencies);
    raises ValueError naming unknown ones."""
    if not only:
        return set(_SECTIONS)
    wanted = set(only.split(","))
    unknown = wanted - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections: {sorted(unknown)}")
    for s in tuple(wanted):
        wanted |= _DEPS.get(s, set())
    return wanted


def note_accuracy(served: list, truth: list) -> float:
    """Fraction of positions where the served MIDI equals the truth's,
    over the shorter of the two."""
    n = min(len(truth), len(served))
    return float(sum(served[i] == truth[i] for i in range(n)) / max(n, 1))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--out", default=None,
                   help="write the report JSON here (nothing is written "
                        "without it)")
    p.add_argument("--only", default=None,
                   help="comma-separated subset of sections to (re)run "
                        f"({','.join(_SECTIONS)}); with --out, the other "
                        "sections are kept from the existing file. "
                        "Dependencies are pulled in automatically.")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    try:
        wanted = wanted_sections(args.only)
    except ValueError as e:
        p.error(str(e))

    import numpy as np
    import torch

    from music_generation_tpu_torch.device import resolve_device
    from music_generation_tpu_torch.frontend import load_lexicon, note_to_midi
    from music_generation_tpu_torch.models.melody import (
        lyric_dictionary_from_chars, note_dictionary)
    from music_generation_tpu_torch.models.melody.transformer import (
        causal_mask)
    from music_generation_tpu_torch.train.data import to_device
    from music_generation_tpu_torch.train.seq import (_MelodyBatcher,
                                                      _stable_hash,
                                                      _toy_melody_pairs,
                                                      _toy_melody_pairs_prev,
                                                      build_family,
                                                      train_family)
    from music_generation_tpu_torch.train.toydata import _SYL_TEXT, _TOY_NOTES

    device = resolve_device(args.device)
    t_start = time.time()
    report = {"steps": args.steps}
    if args.only and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
        report["steps"] = args.steps
    chars = sorted(load_lexicon().monosyllable.keys())
    ld, nd = lyric_dictionary_from_chars(chars), note_dictionary()

    def train(family, steps, **kw):
        kw.setdefault("batch_size", 32)
        kw.setdefault("tiny", True)
        return train_family(family, steps=steps, log_every=max(steps // 4, 1),
                            return_model=True, device=device, **kw)

    def on_device(batch):
        return to_device(batch, device)

    # ---- 1. the melody note model on the deterministic mapping ----
    note_model = None
    if "melody_note" in wanted:
        note_losses, note_model = train("melody_note", args.steps)
        note_model.eval()
        b = on_device(_MelodyBatcher(_toy_melody_pairs(n=64, seed=999), ld,
                                     nd).batch(64))
        src, tgt_in, tgt_out = b["src"], b["tgt_in"], b["tgt_out"]
        with torch.no_grad():
            logits = note_model(src, tgt_in,
                                (src != 0)[:, None, None, :].int(),
                                causal_mask(tgt_in.shape[1], device))
        pred, tgt = logits.argmax(-1).cpu().numpy(), tgt_out.cpu().numpy()
        mask = tgt != 0
        report["melody_note"] = {
            "first_loss": round(note_losses[0], 4),
            "final_loss": round(note_losses[-1], 4),
            "heldout_accuracy": round(float((pred[mask] == tgt[mask])
                                            .mean()), 4),
            "random_baseline": round(1.0 / nd.size, 4)}

    # ---- 1b. previous-sentence conditioning ----
    if "melody_note_prev" in wanted:
        # the arpeggio-continuation task needs ~1000 tiny steps to saturate
        prev_steps = max(args.steps, 1000)
        prev_losses, prev_model = train("melody_note_prev", prev_steps)
        prev_model.eval()
        hb = on_device(_MelodyBatcher(_toy_melody_pairs_prev(n=64, seed=998),
                                      ld, nd).batch(64))

        @torch.no_grad()
        def prev_acc(prev_ids):
            """(teacher-forced, position-0, free-running) accuracies: only
            the last two depend on the previous-sentence memory alone."""
            src = hb["src"]
            mem, attn = prev_model.prev_memory(
                src, (src != 0)[:, None, None, :].int(), prev_ids)
            t_len = hb["tgt_in"].shape[1]
            lg = prev_model.logits(prev_model.decode(
                mem, attn, hb["tgt_in"], causal_mask(t_len, device)))
            pr, tgt = lg.argmax(-1).cpu().numpy(), hb["tgt_out"].cpu().numpy()
            m = tgt != 0
            tf_acc = float((pr[m] == tgt[m]).mean())
            pos0 = float((pr[:, 0] == tgt[:, 0]).mean())
            cur = torch.zeros_like(hb["tgt_in"])
            cur[:, 0] = hb["tgt_in"][:, 0]  # BOS
            for t in range(t_len - 1):
                lg = prev_model.logits(prev_model.decode(
                    mem, attn, cur, causal_mask(t_len, device)))
                cur[:, t + 1] = lg[:, t].argmax(-1)
            fr, tgt_notes = cur[:, 1:].cpu().numpy(), tgt[:, :-1]
            m2 = tgt_notes != 0
            fr_acc = float((fr[:, : tgt_notes.shape[1]][m2]
                            == tgt_notes[m2]).mean())
            return tf_acc, pos0, fr_acc

        t_tf, t_p0, t_fr = prev_acc(hb["prev"])
        s_tf, s_p0, s_fr = prev_acc(torch.roll(hb["prev"], 1, dims=0))
        report["melody_note_prev"] = {
            "first_loss": round(prev_losses[0], 4),
            "final_loss": round(prev_losses[-1], 4),
            "heldout_accuracy_true_prev": round(t_tf, 4),
            "heldout_accuracy_shuffled_prev": round(s_tf, 4),
            "pos0_accuracy_true_prev": round(t_p0, 4),
            "pos0_accuracy_shuffled_prev": round(s_p0, 4),
            "free_running_accuracy_true_prev": round(t_fr, 4),
            "free_running_accuracy_shuffled_prev": round(s_fr, 4),
            "note": "free-running/pos0 probe the prev memory alone; "
                    "teacher-forced leaks structure via target history",
        }
        assert t_fr - s_fr >= 0.3, (t_fr, s_fr)

    # ---- 1c. the seq2seq RNN family (melody_v2): train -> serve decode ----
    if "seq2seq" in wanted:
        s2s_steps = max(args.steps, 800)
        s2s_losses, s2s_models = train("seq2seq", s2s_steps)
        from music_generation_tpu_torch.models.melody.seq2seq import (
            Seq2SeqConfig)
        from music_generation_tpu_torch.models.melody.seq2seq_api import (
            Seq2SeqMelodyGenerator, default_langs)
        s2s = Seq2SeqMelodyGenerator(
            *default_langs(), cfg=Seq2SeqConfig(
                en_embedding_dim=32, de_embedding_dim=32, hidden_dim=32),
            device=device)
        for name in ("lyric2note", "lyric2duration", "note2duration"):
            setattr(s2s, name, s2s_models[name].eval())
        rng_s = np.random.RandomState(7)
        s2s_chars = sorted({ch for line, *_ in _toy_melody_pairs(n=64, seed=0)
                            for ch in line})
        hits = tot = 0
        per_sentence = []
        for _ in range(16):
            s2s_text = "".join(rng_s.choice(s2s_chars, size=6))
            _lyr, s2s_notes, _durs = s2s.get_melody(s2s_text)
            # get_melody inserts breath 'rest' notes at seeded positions
            sung = [x for x in s2s_notes if x != "rest"]
            truth = [_TOY_NOTES[_stable_hash(ch) % len(_TOY_NOTES)]
                     for ch in s2s_text]
            n = min(len(truth), len(sung))
            hits += sum(sung[i] == truth[i] for i in range(n))
            tot += n
            per_sentence.append(round(float(np.mean(
                [sung[i] == truth[i] for i in range(n)])), 3) if n else 0.0)
        report["seq2seq"] = {"first_loss": round(s2s_losses[0], 4),
                             "final_loss": round(s2s_losses[-1], 4),
                             "steps": s2s_steps,
                             "served_note_accuracy": round(
                                 hits / max(tot, 1), 4),
                             "served_eval_chars": tot,
                             "per_sentence_accuracy": per_sentence}

    # ---- 2. the duration head ----
    dur_model = None
    if "duration_mse" in wanted:
        dur_losses, dur_model = train("duration_mse", args.steps)
        report["duration_mse"] = {"first_loss": round(dur_losses[0], 4),
                                  "final_loss": round(dur_losses[-1], 4)}

    # ---- 2b. duration_sdp and telemelody at full width ----
    if "full" in wanted:
        full_steps = min(args.steps, 300)
        for fam in ("duration_sdp", "telemelody"):
            t0 = time.time()
            fl, _ = train(fam, full_steps, batch_size=16, tiny=False)
            first = float(np.mean(fl[:10])) if len(fl) >= 10 else fl[0]
            last = float(np.mean(fl[-10:])) if len(fl) >= 10 else fl[-1]
            report[fam] = {"size": "full", "steps": full_steps,
                           "first_loss_mean10": round(first, 4),
                           "final_loss_mean10": round(last, 4),
                           "wall_s": round(time.time() - t0, 1)}
            assert last < first * 0.9, (fam, first, last)

    # ---- 3. serve the trained weights: lyrics -> WAV ----
    songs = result = None
    if "e2e" in wanted:
        from music_generation_tpu_torch.compat import save_params
        from music_generation_tpu_torch.serve import app
        with tempfile.TemporaryDirectory() as served:
            save_params(os.path.join(served, "melody_notes.pt"),
                        note_model.eval())
            save_params(os.path.join(served, "melody_duration.pt"),
                        dur_model.eval())
            sargs, scfg = app.configure(["--tiny", "--device", str(device),
                                         "--checkpoint-dir", served])
            songs = app.build_songs(sargs, scfg)
        demo_text = "".join(_SYL_TEXT[s] for s in ("ni", "hao", "shi", "jie",
                                                   "tian", "di"))
        result = songs.synthesize_song(demo_text)
        truth = [note_to_midi(_TOY_NOTES[_stable_hash(ch) % len(_TOY_NOTES)])
                 for ch in demo_text]
        served_midi = [int(note_to_midi(n)) if n != "rest" else -1
                       for n in result.notes[0]]
        report["e2e"] = {
            "lyrics": demo_text,
            "wav_bytes": len(result.wav_bytes),
            "n_sentences": len(result.lyrics_sentences),
            "note_accuracy_vs_mapping": round(note_accuracy(served_midi,
                                                            truth), 4),
        }

    # ---- 3b. trained lyric LMs: perplexity gap, keyword -> song ----
    if "lm" in wanted:
        from music_generation_tpu_torch.models.lyrics import (
            LyricGeneratorT5, default_tokenizer, t5_config_for)
        from music_generation_tpu_torch.pipeline.synthesis import (
            split_sentences)
        from music_generation_tpu_torch.train.seq import (_toy_lyric_lines,
                                                          lyric_grammar_check)
        corpus = _toy_lyric_lines(n=128, seed=0)
        lm_steps = max(args.steps, 1200)
        lm_models = {}
        for fam in ("t5", "gpt2"):
            fam_losses, lm_models[fam] = train(fam, lm_steps)
            model0, loss_fn, batcher = build_family(fam, True, None,
                                                    device=device)
            eval_b = on_device(batcher.batch(64))
            with torch.no_grad():
                ce_trained = float(loss_fn(lm_models[fam].eval(), eval_b))
                ce_random = float(loss_fn(model0.eval(), eval_b))
            report[fam] = {
                "first_loss": round(fam_losses[0], 4),
                "final_loss": round(fam_losses[-1], 4),
                "corpus_perplexity_trained": round(float(np.exp(ce_trained)),
                                                   2),
                "corpus_perplexity_random_init": round(
                    float(np.exp(ce_random)), 2),
            }
            assert ce_trained < ce_random * 0.5, (fam, ce_trained, ce_random)

        tok = default_tokenizer("t5", tiny=True)
        lyric_gen = LyricGeneratorT5(
            t5_config_for(tok, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                          num_decoder_layers=1, num_heads=4),
            tokenizer=tok, device=device)
        lyric_gen.model = lm_models["t5"].eval()
        keyword = corpus[0][:2]

        def cand_score(cand):
            # every downstream assert, most important first
            sc = lyric_grammar_check(cand)
            n_sent = len(split_sentences(cand))
            return (float(sc["passed"] and n_sent >= 4), float(n_sent >= 4),
                    float(sc["passed"]), sc["parsed_frac"],
                    sc["phrases_with_word_frac"])

        gen_text, best = "", (-1.0,) * 5
        for _ in range(12):
            cand = lyric_gen.generate(keyword, length=30).replace("-", "")
            if len(cand.strip()) < 12:
                continue
            score = cand_score(cand)
            if score > best:
                gen_text, best = cand, score
            if score[0] == 1.0:
                break
        corpus_chars = set("".join(corpus))
        core = [c for c in gen_text if c.strip()]
        in_corpus = (float(np.mean([c in corpus_chars for c in core]))
                     if core else 0.0)
        bigrams = [tuple(core[i: i + 2]) for i in range(len(core) - 1)]
        distinct2 = len(set(bigrams)) / len(bigrams) if bigrams else 0.0
        kw_song = (songs.synthesize_song(gen_text) if gen_text.strip()
                   else None)
        structure = lyric_grammar_check(gen_text)
        report["keyword_to_song"] = {
            "keyword": keyword,
            "generated_lyrics": gen_text,
            "chars_from_corpus_frac": round(in_corpus, 4),
            "distinct_2": round(distinct2, 4),
            "grammar_check": structure,
            "song_wav_bytes": len(kw_song.wav_bytes) if kw_song else 0,
            "song_sentences": (len(kw_song.lyrics_sentences) if kw_song
                               else 0),
        }
        assert in_corpus >= 0.7, gen_text
        assert kw_song is not None and len(kw_song.wav_bytes) > 1000
        assert len(split_sentences(gen_text)) >= 4, gen_text
        assert distinct2 > 0.5, (distinct2, gen_text)
        assert structure["passed"], (structure, gen_text)

    report["wall_s"] = round(time.time() - t_start, 1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)
    print(json.dumps(report, ensure_ascii=False))
    return report


if __name__ == "__main__":
    main()
