"""End-to-end song synthesis pipeline (host orchestration around the models).

Twin of music_generation_tpu/pipeline/synthesis.py for the served path:
sentence split, whole-song melody, G2P score alignment, one batched SVS
call with on-device int16 peak normalisation, 0.2 s leading pad, WAV bytes,
and, for a melody that gives MIDI tracks (TeleMelody), the rendered
accompaniment mixed under the vocal; the halo-chunked vocoder decode,
streaming (stream_score, stream_song) and pipe-format score lines, and
the batched SVS call over a (data, model) device mesh (``mesh=``).
Inputs are padded to the same (phone, frame) buckets as the JAX package:
the vocoder has no mask, so the frame bucket shapes the last samples of
every sentence and must match for the two packages to agree.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import logging
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..audio.wav import (SAMPLE_RATE, concat_with_delay, mix,
                         normalize_int16, write_wav_bytes)
from ..device import resolve_device
from ..frontend import ScoreFrontend, load_lexicon, midi_to_note
from ..models.melody import (MelodyConfig, MelodyGenerator,
                             lyric_dictionary_from_chars, note_dictionary)
from ..models.svs import SVSConfig, VISinger

SENTENCE_SPLIT_RE = re.compile(r"[.。，,？；;?!！\n]")
PHONE_BUCKETS = (16, 32, 48, 64, 96, 128)
FRAME_BUCKETS = (128, 256, 512, 768, 1024, 1536, 1984)
MIN_SENTENCE_LEN = 2


# the svs_v5 pipeline string-replaces two phrases in every lyric fragment
# before merging (pipline_inference_svs_v5.py:191 of the reference; the v6
# pipeline comments it out again) -- a variant-gated option
LYRIC_REPLACEMENTS = (("飞向远方去飞翔", "永远陪在你身旁"),
                      ("换你的梦", "呵护着你"))


def split_sentences(lyrics: str, min_len: int = MIN_SENTENCE_LEN,
                    replacements: tuple = ()) -> list[str]:
    """Punctuation split + merge of fragments shorter than min_len
    (parity: syn_music :190-204 of the reference); ``replacements``
    applies per-fragment phrase substitutions first (svs_v5's list)."""
    merged, carry = [], ""
    for p in SENTENCE_SPLIT_RE.split(lyrics):
        for old, new in replacements:
            p = p.replace(old, new)
        if len(p) < min_len:
            carry += p + ","
        else:
            merged.append(carry + p)
            carry = ""
    return merged


def _bucket(value: int, buckets: tuple[int, ...]) -> int:
    i = bisect.bisect_left(buckets, value)
    if i < len(buckets):
        return buckets[i]
    return -(-value // 64) * 64


def peak_int16(audio: torch.Tensor, mel_len: torch.Tensor,
               hop: int) -> torch.Tensor:
    """Per-sentence int16 peak normalisation on the device, the reference's
    32767 / max(0.01, peak) over each sentence's valid samples: audio
    [B, S, 1] float -> [B, S] int16, zero past mel_len * hop."""
    a = audio[..., 0]
    valid = (torch.arange(a.shape[1], device=a.device)[None, :]
             < (mel_len * hop)[:, None])
    a = a * valid
    peak = torch.clamp(a.abs().amax(dim=1, keepdim=True), min=0.01)
    return (a * (32767.0 / peak)).to(torch.int16)


def _start_host_copy(t: torch.Tensor):
    """Start t's copy to the host: on a GPU an asynchronous copy into
    pinned memory and an event behind it, so that later work is not held
    up by the copy; on the CPU t itself."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_array(copy) -> np.ndarray:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


class _MeshRow:
    """One data row of a serving mesh: a copy of the model on the row's
    first device whose large weights (parallel.param_shardings) are split
    over the row's devices and gathered onto the first at use. A row of
    one device that is the model's own (``own``) uses the model itself."""

    def __init__(self, model, devices: list, own: bool):
        from ..parallel import param_shardings
        self.device, n_model = devices[0], len(devices)
        self.model = model if own and n_model == 1 else \
            copy.deepcopy(model).to(self.device)
        self.shards, params = {}, dict(self.model.named_parameters())
        for name, axis in param_shardings(self.model, n_model).items():
            if axis is None:
                continue
            p = params[name]
            self.shards[name] = (axis, [c.to(d).clone() for c, d in zip(
                p.detach().chunk(n_model, dim=axis), devices)])
            p.data = torch.empty(0, dtype=p.dtype, device=self.device)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def gathered(self):
        """The row's model with its full weights in place (one caller at
        a time, when it has shards)."""
        if not self.shards:
            yield self.model
            return
        with self._lock:
            saved = {}
            for name, (axis, parts) in self.shards.items():
                mod_name, _, leaf = name.rpartition(".")
                mod = self.model.get_submodule(mod_name)
                saved[name] = (mod, leaf, mod._parameters[leaf])
                mod._parameters[leaf] = torch.cat(
                    [t.to(self.device) for t in parts], dim=axis)
            try:
                yield self.model
            finally:
                for mod, leaf, p in saved.values():
                    mod._parameters[leaf] = p


class SVSSynthesizer:
    """Score -> waveform on one device, batched over sentences.

    ``decode_chunk_frames``: decode the vocoder in windows of that many
    frames, each widened by ``decode_chunk_halo`` frames on both sides and
    centre-cropped (_chunked_decode), which bounds the decoder's
    activations; the halo must cover the decoder's receptive field
    (models.svs.hifigan.receptive_radius_frames) for the windows to give
    the monolithic decode's samples.

    ``mesh``: a parallel.make_mesh grid [n_data][n_model] of devices for
    the batched call (place_on_mesh): the batch is padded to a multiple of
    n_data and each data row's sentences run on that row. The prior noise
    is drawn as on one device, so the sentences' samples do not depend on
    the mesh. The unbatched paths (synthesize_score, stream_score, the
    fused path) stay on ``device``, the mesh's first."""

    # largest sentence batch per device call: inherited; not yet measured
    # on the H100
    MAX_BATCH = 16
    # fixed streaming gain: the decoder output is tanh-bounded to (-1, 1),
    # so a constant scale is safe; a stream cannot use the per-sentence
    # peak normalisation (the peak is in the future)
    STREAM_GAIN = 0.95 * 32767.0

    def __init__(self, cfg: Optional[SVSConfig] = None, seed: int = 0,
                 frontend: Optional[ScoreFrontend] = None, device=None,
                 max_batch: Optional[int] = None,
                 decode_chunk_frames: Optional[int] = None,
                 decode_chunk_halo: int = 24, mesh=None):
        self.device = resolve_device(mesh[0][0] if mesh else device)
        self.cfg = cfg or SVSConfig()
        self.frontend = frontend or ScoreFrontend()
        self.max_batch = max_batch or self.MAX_BATCH
        self.decode_chunk_frames = decode_chunk_frames
        self.decode_chunk_halo = decode_chunk_halo
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self._model = VISinger(self.cfg)
        self._model.to(self.device).eval()
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(seed + 17)
        self.place_on_mesh(mesh or [[self.device]])

    @property
    def model(self) -> VISinger:
        return self._model

    @model.setter
    def model(self, model: VISinger) -> None:
        """A new model, placed on the current mesh."""
        self._model = model
        self.place_on_mesh(self.mesh)

    def place_on_mesh(self, mesh) -> None:
        """Run batched calls on ``mesh`` (a make_mesh grid whose first
        device is this synthesizer's), each row from a copy of the current
        weights: call again after loading others into ``model``. The
        default mesh is the synthesizer's device alone, whose row is the
        model itself."""
        if mesh[0][0] != self.device:
            raise ValueError(f"the mesh starts at {mesh[0][0]}; this "
                             f"synthesizer is on {self.device}")
        self.mesh = mesh
        self._rows = [_MeshRow(self.model, row, own=r == 0)
                      for r, row in enumerate(mesh)]

    def _score_frame_bound(self, score) -> int:
        return (int(np.ceil(score.note_durations.sum()
                            / self.cfg.frame_seconds))
                + len(score.phone_ids) + 8)

    def _batch_inputs(self, scores: list):
        """(max_frames, packed [5, b, t] int32 tensor on the device): phone
        ids, note ids, tone ids, lengths (in column 0) and the float32 note
        durations' bits — one host-to-device copy."""
        t_pad = _bucket(max(len(s.phone_ids) for s in scores), PHONE_BUCKETS)
        frame_bound = max(self._score_frame_bound(s) for s in scores)
        max_frames = min(_bucket(frame_bound, FRAME_BUCKETS),
                         FRAME_BUCKETS[-1])
        packed = np.zeros((5, len(scores), t_pad), np.int32)
        for i, s in enumerate(scores):
            n = len(s.phone_ids)
            packed[0, i, :n] = s.phone_ids
            packed[1, i, :n] = s.note_ids
            packed[2, i, :n] = s.shengdiao_ids
            packed[3, i, 0] = max(n, 1)
            packed[4, i, :n] = np.asarray(s.note_durations,
                                          np.float32).view(np.int32)
        tensor = torch.from_numpy(packed)
        if self.device.type == "cuda":
            tensor = tensor.pin_memory()
        return max_frames, tensor.to(self.device, non_blocking=True)

    def _infer_hidden(self, scores: list,
                      noise: Optional[torch.Tensor] = None):
        """VISinger.infer_hidden of a batch of scores, padded to their
        buckets: (hidden [b, max_frames, inter], mel_len [b], aux)."""
        max_frames, packed = self._batch_inputs(scores)
        return self.model.infer_hidden(
            packed[0], packed[3, :, 0], packed[1],
            packed[4].view(torch.float32), packed[2], max_frames,
            noise=noise, generator=self.generator)

    def _chunked_decode(self, hidden: torch.Tensor,
                        exc: Optional[torch.Tensor] = None,
                        model=None) -> torch.Tensor:
        """The vocoder over frame windows (the JAX twin's lax.scan as a
        loop): ceil(f / chunk) windows of chunk + 2 * halo frames, the last
        output window moved back to end at f; window starts are clamped to
        [0, f - win], never zero-padded, so the first and last windows sit
        on the signal's edges and see the decoder's own conv padding there,
        as the monolithic decode does. Each window's centre chunk is
        cropped at off * hop. Under NSF the full-length source ``exc`` is
        sliced at ws * hop, which keeps its phase continuous. f <= win is
        one plain decode_hidden. ``model``: a mesh row's (default the
        synthesizer's)."""
        model = model or self.model
        chunk, halo = self.decode_chunk_frames, self.decode_chunk_halo
        hop = self.cfg.hop_length
        b, f, _ = hidden.shape
        win = chunk + 2 * halo
        if f <= win:
            return model.decode_hidden(hidden, exc)
        out = torch.empty((b, f * hop, 1), dtype=torch.float32,
                          device=hidden.device)
        for k in range(-(-f // chunk)):
            out_start = min(k * chunk, f - chunk)
            ws = min(max(out_start - halo, 0), f - win)
            off = out_start - ws
            e = None if exc is None else exc[:, ws * hop: (ws + win) * hop]
            y = model.decode_hidden(hidden[:, ws: ws + win], e)
            out[:, out_start * hop: (out_start + chunk) * hop] = \
                y[:, off * hop: (off + chunk) * hop]
        return out

    def _split(self, score, noise) -> list:
        pieces = self.split_oversize(score)
        if noise is not None and len(pieces) > 1:
            raise ValueError(f"an injected prior noise serves one decoder "
                             f"call; this score splits into {len(pieces)}")
        return pieces

    def synthesize(self, text: str, notes: list[str],
                   durations: list[float]) -> np.ndarray:
        """One sentence -> float waveform (un-normalised, trimmed)."""
        return self.synthesize_score(self.frontend.align(text, notes,
                                                         durations))

    @torch.no_grad()
    def synthesize_score(self, score,
                         noise: Optional[torch.Tensor] = None
                         ) -> np.ndarray:
        """One score -> its float64 waveform, un-normalised and trimmed to
        its frames, from the monolithic decode; an over-long score splits
        at syllables and its pieces are joined. ``noise`` [1, max_frames,
        inter] replaces the prior sample (a score that does not split)."""
        pieces = self._split(score, noise)
        if len(pieces) > 1:
            return np.concatenate([self.synthesize_score(p) for p in pieces])
        hidden, mel_len, aux = self._infer_hidden([score], noise)
        audio = self.model.decode_hidden(hidden, aux.get("exc"))
        n = int(mel_len[0]) * self.cfg.hop_length
        return audio[0, :n, 0].cpu().numpy().astype(np.float64)

    @torch.no_grad()
    def stream_score(self, score, chunk_frames: Optional[int] = None,
                     noise: Optional[torch.Tensor] = None):
        """Yield int16 waveform chunks as the vocoder decodes them, one per
        window of ``chunk_frames`` (else decode_chunk_frames, else 64)
        frames, with the halo and clamped windows of _chunked_decode: the
        concatenated stream is the monolithic decode at STREAM_GAIN,
        clipped and truncated to int16. Window k + 1's decode is enqueued
        before window k is read on the host, and each window's copy is
        enqueued right behind its own decode, so the host reads window k
        while the device decodes window k + 1. ``noise`` as in
        synthesize_score."""
        pieces = self._split(score, noise)
        if len(pieces) > 1:
            for p in pieces:
                yield from self.stream_score(p, chunk_frames=chunk_frames)
            return
        chunk = chunk_frames or self.decode_chunk_frames or 64
        halo, hop = self.decode_chunk_halo, self.cfg.hop_length
        hidden, mel_len, aux = self._infer_hidden([score], noise)
        exc = aux.get("exc")
        n = int(mel_len[0])
        f = hidden.shape[1]
        win = min(chunk + 2 * halo, f)
        pending = []
        for out_start in range(0, n, chunk):
            m = min(chunk, n - out_start)
            ws = min(max(out_start - halo, 0), f - win)
            off = out_start - ws
            e = None if exc is None else exc[:, ws * hop: (ws + win) * hop]
            y = self.model.decode_hidden(hidden[:, ws: ws + win], e)
            pcm = torch.clamp(y[0, off * hop: (off + m) * hop, 0]
                              * self.STREAM_GAIN, -32768.0, 32767.0)
            pending.append(_start_host_copy(pcm.to(torch.int16)))
            if len(pending) > 1:
                yield _host_array(pending.pop(0))
        for copy in pending:
            yield _host_array(copy)

    def split_oversize(self, score, cap: int = FRAME_BUCKETS[-1]) -> list:
        """Split a score whose frame bound exceeds the TextPostNet position
        table (FRAME_BUCKETS[-1]) into syllable-aligned sub-scores, so no
        audio is dropped."""
        if self._score_frame_bound(score) <= cap:
            return [score]
        t = len(score.phone_ids)
        starts = list(score.syllable_bounds())
        ends = starts[1:] + [t]
        pieces, lo = [], 0
        for s, e in zip(starts, ends):
            if (s > lo and self._score_frame_bound(score.slice_phones(lo, e))
                    > cap):
                pieces.append(score.slice_phones(lo, s))
                lo = s
        pieces.append(score.slice_phones(lo, t))
        logging.getLogger("music_generation_tpu_torch").warning(
            "sentence frame bound %d exceeds %d: split into %d sub-scores "
            "at syllable boundaries (no audio dropped)",
            self._score_frame_bound(score), cap, len(pieces))
        return pieces

    def synthesize_batch(self, scores: list,
                         noise: Optional[torch.Tensor] = None
                         ) -> list[np.ndarray]:
        """Independent sentences -> per-sentence int16 waveforms, in device
        calls of at most max_batch sentences. Over-long sentences split at
        syllable boundaries and their pieces are re-joined. ``noise``
        [b, max_frames, inter] replaces the prior sample (one call only)."""
        if not scores:
            return []
        groups = [self.split_oversize(s) for s in scores]
        if any(len(g) > 1 for g in groups):
            wavs = self.synthesize_batch([p for g in groups for p in g])
            out, k = [], 0
            for g in groups:
                out.append(np.concatenate(wavs[k: k + len(g)])
                           if len(g) > 1 else wavs[k])
                k += len(g)
            return out
        if len(scores) > self.max_batch:
            # enqueue every chunk before collecting any: the host prepares
            # chunk k+1 while the device runs chunk k
            handles = [self.dispatch_batch(scores[k: k + self.max_batch])
                       for k in range(0, len(scores), self.max_batch)]
            return [w for h in handles for w in self.collect_batch(h)]
        return self.collect_batch(self.dispatch_batch(scores, noise=noise))

    @torch.no_grad()
    def dispatch_batch(self, scores: list,
                       noise: Optional[torch.Tensor] = None):
        """Enqueue one batched SVS call (no host sync): infer (the vocoder
        chunked when decode_chunk_frames is set), then the per-sentence
        32767/max(0.01, peak) int16 normalisation on the device. Returns a
        handle for collect_batch. Each data row of the mesh runs its
        block of the batch (padded to a multiple of the rows) from the
        prior noise one device would draw."""
        max_frames, packed = self._batch_inputs(scores)
        b, n_data = len(scores), len(self._rows)
        if noise is None:
            noise = torch.randn((b, max_frames, self.cfg.inter_channels),
                                generator=self.generator, device=self.device)
        k = -(-b // n_data)
        pad = k * n_data - b
        if pad:  # padding rows: one phone, no duration, zero noise
            extra = torch.zeros((5, pad, packed.shape[2]), dtype=packed.dtype,
                                device=packed.device)
            extra[3, :, 0] = 1
            packed = torch.cat([packed, extra], dim=1)
            noise = torch.cat([noise,
                               noise.new_zeros((pad, *noise.shape[1:]))])
        pieces = []
        for r, row in enumerate(self._rows):
            with row.gathered() as model:
                pieces.append(self._infer_decode(
                    model, packed[:, r * k: (r + 1) * k].to(row.device),
                    max_frames, noise[r * k: (r + 1) * k].to(row.device)))
        audio = torch.cat([a.to(self.device) for a, _ in pieces])[:b]
        mel_len = torch.cat([m.to(self.device) for _, m in pieces])[:b]
        return audio, mel_len, b

    def _infer_decode(self, model, packed: torch.Tensor, max_frames: int,
                      noise: Optional[torch.Tensor]):
        """(int16 audio [b, S], mel_len [b]) of one packed batch through
        ``model``: infer_hidden, the vocoder (chunked when
        decode_chunk_frames is set), the int16 peak normalisation."""
        hidden, mel_len, aux = model.infer_hidden(
            packed[0], packed[3, :, 0], packed[1],
            packed[4].view(torch.float32), packed[2], max_frames,
            noise=noise, generator=self.generator)
        if self.decode_chunk_frames:
            audio = self._chunked_decode(hidden, aux.get("exc"), model)
        else:
            audio = model.decode_hidden(hidden, aux.get("exc"))
        return peak_int16(audio, mel_len, self.cfg.hop_length), mel_len

    def collect_batch(self, handle) -> list[np.ndarray]:
        audio, mel_len, b = handle
        audio = audio.cpu().numpy()
        mel_len = mel_len.cpu().numpy()
        return [audio[i, : int(mel_len[i]) * self.cfg.hop_length]
                for i in range(b)]

    def batch_cost_analysis(self, scores: list) -> dict:
        """{"flops": n} of one dispatch_batch of these scores, counted by
        torch.utils.flop_counter.FlopCounterMode while the batch runs once:
        matrix products, convolutions (transposed ones too) and attention,
        two FLOPs per multiply-add. Elementwise work is not counted, which
        XLA's cost_analysis (the JAX twin's source) does count. The prior
        draw it takes is given back, so later requests draw as if it had
        not run."""
        from torch.utils.flop_counter import FlopCounterMode
        state = self.generator.get_state()
        try:
            with FlopCounterMode(display=False) as counter:
                self.dispatch_batch(scores)
        finally:
            self.generator.set_state(state)
        return {"flops": counter.get_total_flops()}

    def synthesize_pipe_format(self, line: str) -> np.ndarray:
        """A pipe-format score line, 'name|lyrics|pitches|durations'
        (space-separated pitches and seconds), -> its float waveform."""
        metas = line.split("|")
        return self.synthesize(metas[1].replace(" ", ""), metas[2].split(" "),
                               [float(x) for x in metas[3].split(" ")])


@dataclass
class SongResult:
    wav_bytes: bytes
    lyrics_sentences: list[str]
    notes: list[list[str]]
    timings: dict = field(default_factory=dict)
    sentence_samples: list[int] = field(default_factory=list)


class SongSynthesizer:
    """Full lyrics -> song (multi-speaker via per-speaker SVS models)."""

    def __init__(self, melody, synthesizers: dict[int, SVSSynthesizer],
                 lyric_replacements: tuple = (),
                 mix_accompaniment: bool = False,
                 accompaniment_gain: float = 0.8):
        # a MelodyGenerator (whole-song generate_song) or any generator
        # with generate(sentence, index, previous_notes); one that also
        # keeps the MIDI tracks of its last sentence in ``last_tracks``
        # (TeleMelody) can be mixed under the vocal
        self.melody = melody
        self.synthesizers = synthesizers  # singer_id -> SVSSynthesizer
        # svs_v5's phrase substitutions (LYRIC_REPLACEMENTS when the
        # variant enables them)
        self.lyric_replacements = tuple(lyric_replacements)
        # pipeline v1 of the reference: accompaniment_gain * the rendered
        # MIDI + the vocal (pipline_inference.py:221-232)
        self.mix_accompaniment = mix_accompaniment
        self.accompaniment_gain = accompaniment_gain
        # melody decode carries previous-sentence state; serialize it so
        # concurrent requests (serve/batching.py) stay race-free while the
        # SVS stage batches across requests
        self._melody_lock = threading.Lock()

    def _scores(self, svs, sentences: list[str]):
        """The melody of every sentence, then its aligned score: (note
        names per sentence, scores, MIDI tracks per sentence: the
        generator's last_tracks, or None). The melody runs under
        _melody_lock."""
        tracks = []
        with self._melody_lock:
            if hasattr(self.melody, "generate_song"):
                outs = self.melody.generate_song(sentences)
            else:  # sentence by sentence, each seeing the previous notes
                outs, previous = [], []
                for k, sentence in enumerate(sentences):
                    out = self.melody.generate(
                        sentence, index=k, previous_notes=previous or None)
                    previous = out[1]
                    outs.append(out)
                    tracks.append(getattr(self.melody, "last_tracks", None))
        all_notes, scores = [], []
        for out_lyric, note_tokens, durations in outs:
            note_names = [midi_to_note(int(m)) if m != "rest" else "rest"
                          for m in note_tokens]
            all_notes.append(note_names)
            scores.append(svs.frontend.align(out_lyric, note_names,
                                             durations))
        return all_notes, scores, tracks

    def synthesize_song(self, lyrics: str, singer_id: int = 0,
                        batch_svs: bool = True,
                        svs_batch_fn=None) -> SongResult:
        """``svs_batch_fn(scores) -> wavs`` (when given) replaces the direct
        SVS call — the serving tier passes a cross-request coalescer
        (serve/batching.SVSBatcher.fn_for). ``batch_svs=False`` synthesizes
        sentence by sentence (synthesize_score) and peak-normalises each on
        the host."""
        svs = self.synthesizers.get(singer_id, self.synthesizers[0])
        sentences = split_sentences(lyrics,
                                    replacements=self.lyric_replacements)
        t_start = time.time()
        all_notes, scores, tracks = self._scores(svs, sentences)
        melody_s = time.time() - t_start

        t0 = time.time()
        if svs_batch_fn is not None or batch_svs:
            wavs = (svs_batch_fn or svs.synthesize_batch)(scores)
        else:
            wavs = [normalize_int16(svs.synthesize_score(s)) for s in scores]
        svs_s = time.time() - t0
        song = concat_with_delay(wavs, delay_seconds=0.2)
        timings = {"melody_s": melody_s, "svs_s": svs_s}
        if self.mix_accompaniment and any(tracks):
            t0 = time.time()
            song = self._mix_accompaniment(song, wavs, tracks)
            timings["accompaniment_s"] = time.time() - t0
        return SongResult(
            wav_bytes=write_wav_bytes(song),
            lyrics_sentences=sentences,
            notes=all_notes,
            timings={"total_s": time.time() - t_start, **timings},
            sentence_samples=[len(w) for w in wavs],
        )

    def stream_song(self, lyrics: str, singer_id: int = 0,
                    sample_rate: int = SAMPLE_RATE):
        """Yield int16 chunks of the whole song as the vocoder decodes
        them: the melody of every sentence first (under _melody_lock, as
        synthesize_song runs it), then the 0.2 s silent lead-in of
        concat_with_delay, then each sentence's stream_score windows. A
        stream has the fixed STREAM_GAIN, not the per-sentence peak
        normalisation: it cannot revisit samples already sent."""
        svs = self.synthesizers.get(singer_id, self.synthesizers[0])
        sentences = split_sentences(lyrics,
                                    replacements=self.lyric_replacements)
        _, scores, _ = self._scores(svs, sentences)
        yield np.zeros(int(0.2 * sample_rate), np.int16)
        for score in scores:
            yield from svs.stream_score(score)

    def _mix_accompaniment(self, song: np.ndarray, wavs: list,
                           sentence_tracks: list,
                           sample_rate: int = SAMPLE_RATE) -> np.ndarray:
        """Each sentence's MIDI tracks rendered at that sentence's offset in
        the song (after the 0.2 s lead-in), on the vocal's clock
        (sec_per_tick 0.001: the melody's durations are ticks / 1000 s),
        scaled to a 32767 peak, then mix(accompaniment, song,
        accompaniment_gain) on the host."""
        from ..audio.render import render_tracks
        total = len(song) / sample_rate
        accomp = np.zeros(len(song), np.float32)
        offset = 0.2  # concat_with_delay's lead-in
        for wav, tracks in zip(wavs, sentence_tracks):
            if tracks:
                r = render_tracks(tracks, total_seconds=total - offset,
                                  sample_rate=sample_rate, gain=1.0,
                                  sec_per_tick=0.001)
                i0 = int(offset * sample_rate)
                n = min(len(r), len(song) - i0)
                accomp[i0: i0 + n] += r[:n]
            offset += len(np.asarray(wav).ravel()) / sample_rate
        peak = np.abs(accomp).max()
        if peak > 0:
            accomp = accomp / peak * 32767.0
        return mix(accomp, song, self.accompaniment_gain)


def tiny_configs(src_vocab: int) -> tuple[MelodyConfig, SVSConfig]:
    """The tiny random-model configs of the JAX package's
    build_default_song_synthesizer(tiny=True)."""
    return (MelodyConfig(src_vocab=src_vocab, tgt_vocab=37, n_layers=1,
                         d_model=32, d_ff=64, n_heads=2),
            SVSConfig(inter_channels=16, hidden_channels=16,
                      filter_channels=32, n_heads=2, n_layers=1,
                      spec_channels=65, resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3),),
                      upsample_rates=(8, 8, 2, 2),
                      upsample_initial_channel=32,
                      upsample_kernel_sizes=(16, 16, 4, 4)))


def build_melody_generator(tiny: bool = False, seed: int = 0, device=None,
                           duration_variant: str = "mse"
                           ) -> MelodyGenerator:
    """Random-initialised melody generator, full width or tiny, on
    ``device`` (default cuda), with MSE or SDP durations (the SDP model
    keeps its full SDPDurationConfig even when tiny, as in the JAX
    package)."""
    # the lyric dictionary covers the full monosyllable charset, sorted as
    # in the JAX package so checkpoints transfer
    lyric_dict = lyric_dictionary_from_chars(
        sorted(load_lexicon().monosyllable.keys()))
    mcfg = (tiny_configs(lyric_dict.size)[0] if tiny
            else MelodyConfig(src_vocab=lyric_dict.size, tgt_vocab=37))
    return MelodyGenerator(lyric_dict, note_dictionary(), cfg=mcfg,
                           duration_variant=duration_variant, seed=seed,
                           device=device)


def build_default_song_synthesizer(tiny: bool = False, n_speakers: int = 3,
                                   seed: int = 0, device=None,
                                   fused: bool = False):
    """Random-initialised full pipeline (no trained weights ship with the
    repository). Runs on ``device`` (default cuda). ``fused`` returns the
    FusedSongSynthesizer (pipeline/fused.py) over the same models."""
    device = resolve_device(device)
    melody = build_melody_generator(tiny, seed, device)
    synths = build_svs_synthesizers(tiny, n_speakers, seed, device)
    if fused:
        from .fused import FusedSongSynthesizer
        return FusedSongSynthesizer(melody, synths)
    return SongSynthesizer(melody, synths)


def build_svs_synthesizers(tiny: bool = False, n_speakers: int = 3,
                           seed: int = 0, device=None,
                           decoder: str = "hifigan", nsf: bool = False,
                           f0_mode: str = "predict",
                           f0_residual: bool = False,
                           decoder_bf16: bool = False
                           ) -> dict[int, SVSSynthesizer]:
    """One random-initialised SVSSynthesizer per speaker (speaker i from
    ``seed + i``), sharing one score frontend, on ``device`` (default
    cuda). The SVS options are serve.app's flags: ``decoder`` (hifigan,
    istft or mb_istft), ``nsf`` and ``f0_residual`` must match how the
    checkpoints were trained; ``f0_mode`` ("predict" or "score") and
    ``decoder_bf16`` are inference choices over the same parameters."""
    device = resolve_device(device)
    # the tiny SVS config does not depend on the vocabulary
    scfg = dataclasses.replace(tiny_configs(0)[1] if tiny else SVSConfig(),
                               decoder_type=decoder, nsf=nsf,
                               f0_mode=f0_mode, f0_residual=f0_residual,
                               decoder_bf16=decoder_bf16)
    frontend = ScoreFrontend()
    return {i: SVSSynthesizer(scfg, seed=seed + i, frontend=frontend,
                              device=device)
            for i in range(n_speakers)}
