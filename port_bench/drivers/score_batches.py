"""Offline rendering of note-level scores in batches, as a catalog job.

Each batch is ``batch`` one-line scores for one singer: the program's
front end aligns each (``ScoreFrontend.align``), ``SVSSynthesizer.
dispatch_batch`` enqueues the batch, and the batch dispatched before it is
collected (``collect_batch``), so one batch is always in flight ahead of
the host. The melody and the serving batcher are bypassed. A score is
syllables of ``syllable_seconds`` each up to a line of ``line_seconds``,
at MIDI pitches in ``midi``; every batch holds the same lines' syllable
durations (drawn once from the mix's ``sizes_seed``) in the seed's order,
with the seed's characters and pitches, and the singers take turns.

End-to-end: ``audio_s_per_s``, the seconds of audio of every batch
dispatched in the window over the window's wall seconds, up to the last
collection. The comparison takes a draw from the seed of the window's
first ``check_pool`` batches and works each of their scores out again
with the plain reference.
"""

from __future__ import annotations

import random
import re
import sys
import threading
import time

import numpy as np
import torch

from ..harness import stats, weights
from ..harness.trace import Window
from . import common

DECODER = "port_bench.decode_hidden"
_PINYIN = re.compile(r"[a-z]+[1-5]")


def han_chars() -> list:
    """The lexicon's monosyllabic Han characters with a plain pinyin."""
    from ..reference.frontend import load_lexicon
    lex = load_lexicon()
    return [c for c in sorted(lex.monosyllable)
            if "一" <= c <= "鿿" and _PINYIN.fullmatch(
                lex.monosyllable[c])]


def reference_models(cell, seed: int, device, tiny: bool,
                     singers=None) -> dict:
    """{singer: the reference VISinger} with the weights made from
    ``seed`` (the program gets the same, ``weights.hand_over``)."""
    from ..reference.models.svs import SVSConfig, VISinger
    scfg = common.as_config(SVSConfig, common.sizes(cell.config, tiny)["svs"])
    return {i: weights.build(lambda: VISinger(scfg), device, seed,
                             f"svs.{i}")
            for i in (range(cell.config["n_speakers"]) if singers is None
                      else singers)}


def make_scores(traffic: dict, seed: int, tag: str = "traffic",
                n: int = 0) -> list:
    """[(singer, [(text, note names, seconds)] * batch)] batches. Every
    batch holds the same ``batch`` lines (drawn once from ``sizes_seed``),
    in the seed's order, and batch k is for singer k mod ``singers``: the
    same work in every batch and for every seed."""
    from ..reference.frontend.pitch import midi_to_note
    size_rng = random.Random(traffic["sizes_seed"])
    lo, hi = traffic["syllable_seconds"]
    lines = []
    for _ in range(traffic["batch"]):
        target = size_rng.uniform(*traffic["line_seconds"])
        durs = []
        while sum(durs) < target or not durs:
            durs.append(round(size_rng.uniform(lo, hi), 3))
        lines.append(durs)
    rng = random.Random(weights.sub_seed(seed, tag))
    chars = han_chars()
    out = []
    for k in range(n or traffic["pool"]):
        order = lines[:]
        rng.shuffle(order)
        batch = []
        for durs in order:
            text = "".join(rng.choice(chars) for _ in durs)
            notes = [midi_to_note(rng.randint(*traffic["midi"]))
                     for _ in durs]
            batch.append((text, notes, durs))
        out.append((k % traffic["singers"], batch))
    return out


def build(cell, seed: int, device: str, tiny: bool) -> dict:
    from music_generation_tpu_torch.pipeline.synthesis import \
        build_svs_synthesizers
    cfg = cell.config
    synths = build_svs_synthesizers(tiny, cfg["n_speakers"], seed=seed,
                                    device=device, decoder=cfg["decoder"],
                                    f0_mode=cfg["f0"])
    sz = common.sizes(cfg, tiny)
    ref = reference_models(cell, common.weights_seed(cell, seed), device,
                           tiny)
    for i, svs in synths.items():
        common.same_config(svs.cfg, sz["svs"], "svs")
        weights.hand_over(svs.model, ref.pop(i))
        svs.generator.manual_seed(weights.sub_seed(seed, f"svs.noise.{i}"))
    del ref
    common.free_device()
    return synths


class Capture:
    """Wrappers around each synthesizer's batched call: the noise
    generator's state each call starts from, the padded shapes, and for
    the sampled batches the hidden state, mel, F0, duration fractions and
    frames of every row."""

    def __init__(self, synths: dict, sampled: set):
        self.sampled = sampled
        self.tl = threading.local()
        self.calls = {}
        self._undo = []
        for svs in synths.values():
            self._wrap(svs)

    def _patch(self, obj, name, fn):
        self._undo.append((obj, name))
        setattr(obj, name, fn)

    def _wrap(self, svs) -> None:
        cap = self
        dispatch = svs.dispatch_batch

        def dispatch_batch(scores, noise=None):
            k = getattr(cap.tl, "batch", None)
            call = {"state": svs.generator.get_state(), "b": len(scores)}
            cap.tl.call = call if k in cap.sampled else None
            if k is not None:
                cap.calls[k] = call
            try:
                with torch.profiler.record_function("port_bench.svs_call"):
                    return dispatch(scores, noise)
            finally:
                cap.tl.call = None
        self._patch(svs, "dispatch_batch", dispatch_batch)

        model = svs.model
        infer_hidden = model.infer_hidden

        def infer(phones, x_lengths, note_ids, note_durations, shengdiao,
                  max_frames, **k):
            hidden, mel_len, aux = infer_hidden(
                phones, x_lengths, note_ids, note_durations, shengdiao,
                max_frames, **k)
            call = getattr(cap.tl, "call", None)
            if call is not None:
                call.update(t_pad=phones.shape[1], max_frames=max_frames,
                            hidden=hidden.clone(), mel_len=mel_len.clone(),
                            mel=aux["mel_predict"].clone(),
                            log_f0=aux["log_f0"].clone(),
                            frac=aux["frac"].clone(),
                            frames=aux["frames"].clone())
            return hidden, mel_len, aux
        self._patch(model, "infer_hidden", infer)

        decode = model.decode_hidden

        def decode_hidden(*a, **k):
            with torch.profiler.record_function(DECODER):
                return decode(*a, **k)
        self._patch(model, "decode_hidden", decode_hidden)

    def uninstall(self) -> None:
        for obj, name in reversed(self._undo):
            delattr(obj, name)
        self._undo.clear()


def render(synths: dict, batches: list, first: int, deadline: float,
           cap: Capture, sink: dict) -> int:
    """Batches from index ``first`` until ``deadline``, one dispatched
    ahead of the collection; ``sink[k]`` gets batch k's int16 samples.
    Returns the index after the last batch dispatched."""
    pending = None
    k = first
    while k < len(batches) and time.time() < deadline:
        singer, items = batches[k]
        svs = synths[singer]
        with torch.profiler.record_function("port_bench.align"):
            scores = [svs.frontend.align(*item) for item in items]
        cap.tl.batch = k
        handle = svs.dispatch_batch(scores)
        cap.tl.batch = None
        if pending is not None:
            sink[pending[0]] = pending[1].collect_batch(pending[2])
        pending = (k, svs, handle)
        k += 1
    if pending is not None:
        sink[pending[0]] = pending[1].collect_batch(pending[2])
    return k


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", tiny: bool = False, fault=None,
        control: bool = False) -> dict:
    """One run: build the synthesizers, warm them, render for ``seconds``
    (the mix's ``trace_seconds`` when traced), compare the sampled batches.
    ``fault(synthesizers)`` (the CPU tests) breaks the program underneath;
    ``control`` also reads the TF32 control's numbers."""
    common.float32_only()
    traffic = cell.traffic
    synths = build(cell, seed, device, tiny)
    if fault is not None:
        fault(synths)
    batches = make_scores(traffic, seed)
    rng = random.Random(weights.sub_seed(seed, "check"))
    sampled = set(rng.sample(range(traffic["check_pool"]),
                             traffic["check_batches"]))
    warm = make_scores(traffic, seed, "warmup", n=traffic["warmup_batches"])
    cap = Capture(synths, set())
    try:
        render(synths, warm, 0, float("inf"), cap, {})
        cap.calls.clear()
        cap.sampled = sampled
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start
        length = min(seconds, traffic["trace_seconds"]) if trace else seconds
        sink = {}
        with Window(trace, attribute=(DECODER,)) as w:
            end = render(synths, batches, 0, w.t0 + length, cap, sink)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    finally:
        cap.uninstall()
    window_s = w.t1 - w.t0
    audio_s = sum(len(x) for wavs in sink.values() for x in wavs) / 22050.0
    hop = common.sizes(cell.config, tiny)["svs"]["hop_length"]
    counts = ({"flops": svs_flops(cell, tiny, batches, sink, hop)}
              if trace else {})
    del synths
    common.free_device()
    t_check = time.time()
    values = check(cell, cap, batches, sink, seed, device, tiny)
    controls = (check(cell, cap, batches, sink, seed, device, tiny, True)
                if control else None)
    print(f"reference check: {time.time() - t_check:.1f} s",
          file=sys.stderr, flush=True)
    return {"attempted": end, "failed": end - len(sink),
            "end_to_end": {"setup_s": setup_s,
                           "audio_s_per_s": stats.rate(audio_s, window_s)},
            "values": values, "controls": controls,
            "memory_peak_bytes": peak, "trace": w.summary,
            "ctx": common.Ctx(trace=w.summary, window_s=window_s, spans={},
                              counters={"batches": end}, counts=counts)}


def svs_flops(cell, tiny: bool, batches: list, sink: dict,
              hop: int) -> float:
    """The operations the window's scores need, each at its own phones
    and the frames it sounds (counts/svs.py on the reference), not at the
    batch's padding."""
    from ..counts import svs as count
    from ..reference.frontend import ScoreFrontend
    fe = ScoreFrontend()
    lengths = []
    for k, wavs in sink.items():
        for item, wav in zip(batches[k][1], wavs):
            lengths.append((len(fe.align(*item).phone_ids),
                            count.frames_of(len(wav), hop)))
    return count.infer_flops(common.sizes(cell.config, tiny)["svs"],
                             lengths)


def check(cell, cap: Capture, batches: list, sink: dict, seed: int, device,
          tiny: bool, control: bool = False) -> dict:
    """The numbers compared, worst over every score of the sampled
    batches. With ``control`` the control's: the reference in TF32 in the
    program's place, with the same noise and padding, its own frames."""
    from ..reference import pipeline as p
    from ..reference.frontend import ScoreFrontend
    done = sorted(k for k in cap.sampled if k in sink and "hidden" in
                  cap.calls.get(k, {}))
    if len(done) < len(cap.sampled):
        return {}
    singers = sorted({batches[k][0] for k in done})
    ref = reference_models(cell, common.weights_seed(cell, seed), device,
                           tiny, singers)
    judge = Judge(cell, device, tiny)
    fe = ScoreFrontend()
    worst = {}
    for k in done:
        singer, items = batches[k]
        call = cap.calls[k]
        scores = [fe.align(*item) for item in items]
        t_pad, max_frames = p.batch_shape(scores, judge.frame_seconds)
        if (t_pad, max_frames) != (call["t_pad"], call["max_frames"]):
            return {"hidden_rel": float("inf")}
        for row, score in enumerate(scores):
            sv = {"call": call, "row": row,
                  **{n: call[n][row] for n in ("hidden", "mel", "log_f0",
                                               "frac", "frames")},
                  "mel_len": int(call["mel_len"][row])}
            served = sink[k][row]
            if control:
                common.tf32_on()
                try:
                    out = p.infer_sentence(ref[singer], score, t_pad,
                                           max_frames, judge.noise(call, row))
                finally:
                    common.float32_only()
                sv.update({n: out[n] for n in ("hidden", "mel", "log_f0",
                                               "frac", "frames")},
                          mel_len=out["mel_len"])
                served = out["int16"][: out["mel_len"] * judge.hop].cpu() \
                    .numpy()
            got, samples = judge.sentence(ref[singer], score, sv)
            if got is None:
                return {"hidden_rel": float("inf")}
            got["wave_lsb"] = (float(np.abs(samples.astype(np.float64)
                                            - served).max())
                               if len(samples) == len(served)
                               else float("inf"))
            for n, x in got.items():
                worst[n] = max(worst.get(n, 0.0), x)
    return worst


class Judge:
    """The reference's reading of one row of a batched SVS call."""

    def __init__(self, cell, device, tiny: bool):
        from ..reference import pipeline
        self.p = pipeline
        self.device = torch.device(device)
        sz = common.sizes(cell.config, tiny)
        self.inter = sz["svs"]["inter_channels"]
        self.hop = sz["svs"]["hop_length"]
        self.frame_seconds = sz["svs"]["frame_seconds"]

    def noise(self, call: dict, row: int) -> torch.Tensor:
        """Row ``row`` of a batched call's prior noise, drawn again from
        the generator state the call started from."""
        g = torch.Generator(self.device)
        g.set_state(call["state"])
        return torch.randn((call["b"], call["max_frames"], self.inter),
                           generator=g, device=self.device)[row: row + 1]

    def sentence(self, model, score, sv: dict):
        """One sentence of a batched SVS call against the reference at
        batch 1 with the call's padding, its row of the call's prior noise
        (drawn again from the generator state the call started from) and
        the call's frames per phone: ({number: value}, the reference's
        int16 samples), or (None, None) where the shapes cannot hold the
        score."""
        p = self.p
        call, row = sv["call"], sv["row"]
        t_pad, max_frames = call["t_pad"], call["max_frames"]
        if (t_pad < len(score.phone_ids) or max_frames < min(
                p.score_frame_bound(score, self.frame_seconds),
                p.FRAME_BUCKETS[-1])):
            return None, None
        out = p.infer_sentence(model, score, t_pad, max_frames,
                               self.noise(call, row),
                               ph_dur=sv["frames"][None].to(torch.int32))
        n, f = len(score.phone_ids), out["mel_len"]
        if f != sv["mel_len"]:
            return None, None
        mine = torch.floor(out["frac"][:n] * torch.from_numpy(
            score.note_durations).to(self.device) / self.frame_seconds)
        got = {"frac_abs": (sv["frac"][:n] - out["frac"][:n]).abs().max()
               .item(),
               "frames_share": float((mine.to(torch.int64) != sv["frames"]
                                      [:n].to(torch.int64)).float().mean()),
               "hidden_rel": common.rel_gap(sv["hidden"][:f],
                                            out["hidden"][:f]),
               "mel_rel": common.rel_gap(sv["mel"][:f], out["mel"][:f]),
               "f0_rel": common.rel_gap(sv["log_f0"][:f],
                                        out["log_f0"][:f])}
        return got, out["int16"][: f * self.hop].cpu().numpy()
