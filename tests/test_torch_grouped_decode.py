"""The batched SVS call's vocoder at each sentence's own length (CPU, tiny
configs).

SVSSynthesizer.dispatch_batch decodes each row at min(max_frames,
mel_len + halo rounded up to DECODE_STEP) frames, rows of one width in one
call (pipeline.synthesis.decode_groups); the halo is the configured
decoder's receptive radius (models.svs.visinger.decoder_radius_frames).
These tests hold dispatch_batch + collect_batch to the whole-bucket
decode, VISinger.decode_hidden over the full hidden state of the same
infer_hidden and prior noise followed by peak_int16, within 1 int16 LSB
(the convolutions' rounding at another length, then the int16
truncation), for HiFi-GAN, NSF, iSTFT, MB-iSTFT and the chunked decode;
the radius against each decoder's real reach at the published structure;
the plan's invariants; decode_stats and its report in /healthz; and that
a crop without a halo leaves the whole bucket's samples.
"""

import dataclasses
import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
from music_generation_tpu_torch.models.svs.visinger import (
    decoder_radius_frames)
from music_generation_tpu_torch.pipeline import synthesis
from music_generation_tpu_torch.pipeline.synthesis import (
    DECODE_STEP, SVSSynthesizer, decode_groups, peak_int16)

# tests/test_istft_decoder.py's tiny configs (hop 16), as the port's
TINY = SVSConfig(
    inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
    n_layers=1, spec_channels=65, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4),
    upsample_initial_channel=32, upsample_kernel_sizes=(8, 8),
    segment_size=16 * 8, hop_length=16)
CONFIGS = {
    "hifigan": TINY,
    "nsf": dataclasses.replace(TINY, nsf=True, f0_mode="score"),
    "istft": dataclasses.replace(
        TINY, decoder_type="istft", istft_upsample_rates=(4,),
        istft_upsample_kernel_sizes=(8,), istft_hop=4, istft_n_fft=16),
    "mb_istft": dataclasses.replace(
        TINY, decoder_type="mb_istft", mb_upsample_rates=(2,),
        mb_upsample_kernel_sizes=(4,), istft_hop=4, istft_n_fft=16,
        mb_subbands=2),
}
TEXT = "你好世界小小的天有大大的梦想"
NOTES = ["C4", "D4", "E4", "F4", "G4", "A4", "B4", "C5", "D5"]
# (syllables, seconds each): frame bounds 62-989 of the 1,024 bucket, the
# last near its top
SPAN = [(1, 0.3), (3, 0.5), (5, 0.6), (7, 0.6), (9, 0.62)]
# two 0.3 s syllables: the 128 bucket, which every row's mel_len + a halo
# of 64 fills
SHORT = [(2, 0.3)] * 4
# the published decoders' structure (SVSConfig()'s kernels, dilations,
# rates, iSTFT and PQMF) at narrow channels: the reach is the published one
NARROW = SVSConfig(
    inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
    n_layers=1, upsample_initial_channel=32)
RADIUS = {"hifigan": 15, "nsf": 15, "istft": 14, "mb_istft": 25}


def _svs(name: str, **kw) -> SVSSynthesizer:
    return SVSSynthesizer(CONFIGS[name], seed=3, device="cpu", **kw)


def _scores(svs, lines) -> list:
    return [svs.frontend.align(TEXT[:n], NOTES[:n], [s] * n)
            for n, s in lines]


def _noise(svs, scores) -> torch.Tensor:
    max_frames = svs._batch_inputs(scores)[0]
    return torch.randn((len(scores), max_frames, svs.cfg.inter_channels),
                       generator=torch.Generator().manual_seed(5))


def _whole_bucket(svs, scores, noise) -> list:
    """Each row of the whole-bucket decode of the same infer_hidden and
    noise, int16-normalised and cut at mel_len * hop."""
    with torch.no_grad():
        hidden, mel_len, aux = svs._infer_hidden(scores, noise)
        audio = peak_int16(svs.model.decode_hidden(hidden, aux.get("exc")),
                           mel_len, svs.cfg.hop_length).numpy()
    return [audio[i, : int(m) * svs.cfg.hop_length]
            for i, m in enumerate(mel_len)]


def _worst_lsb(got: list, want: list) -> int:
    assert [len(g) for g in got] == [len(w) for w in want]
    assert all(g.dtype == np.int16 for g in got)
    return max(int(np.abs(g.astype(np.int32) - w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("name,chunk", [
    ("hifigan", None), ("nsf", None), ("istft", None), ("mb_istft", None),
    ("hifigan", 48), ("nsf", 48)])
def test_grouped_decode_matches_whole_bucket(name, chunk):
    svs = _svs(name, decode_chunk_frames=chunk)
    assert svs.decode_halo == decoder_radius_frames(svs.cfg)
    scores = _scores(svs, SPAN)
    noise = _noise(svs, scores)
    got = svs.collect_batch(svs.dispatch_batch(scores, noise))
    want = _whole_bucket(svs, scores, noise)
    assert _worst_lsb(got, want) <= 1
    assert min(np.abs(w).max() for w in want) > 1000  # audible rows
    stats = svs.decode_stats
    assert stats["calls"] == 1 and stats["groups"] > 1
    assert stats["frames_padded"] == len(scores) * noise.shape[1]
    assert stats["frames_decoded"] < 0.6 * stats["frames_padded"]


@pytest.mark.parametrize("mel_len,max_frames,halo", [
    ([27, 66, 165, 262, 376], 1024, 24),
    ([40, 41, 104, 105, 0], 128, 24),
    ([5, 200, 7, 1900, 64, 64], 1984, 15),
    ([100] * 16, 1984, 0),
])
def test_group_plan(mel_len, max_frames, halo):
    groups = decode_groups(np.array(mel_len), max_frames, halo)
    rows = np.concatenate([g for _, g in groups])
    assert sorted(rows.tolist()) == list(range(len(mel_len)))
    widths = [w for w, _ in groups]
    assert widths == sorted(set(widths), reverse=True)
    for width, group in groups:
        assert width % DECODE_STEP == 0 or width == max_frames
        assert width <= max_frames
        for r in group:
            assert width >= min(mel_len[r] + halo, max_frames)
            assert width - DECODE_STEP < mel_len[r] + halo  # the least


def test_full_batch_plans_one_group():
    groups = decode_groups(np.array([960, 1000, 1024, 937]), 1024, 24)
    assert len(groups) == 1 and groups[0][0] == 1024
    assert groups[0][1].tolist() == [0, 1, 2, 3]


def test_full_rows_decode_as_one_group_at_the_bucket():
    """A batch whose rows all fill the bucket decodes as one call at
    max_frames, as the whole-bucket decode does."""
    svs = _svs("hifigan")
    svs.decode_halo = 64
    scores = _scores(svs, SHORT)
    noise = _noise(svs, scores)
    assert noise.shape[1] == 128
    got = svs.collect_batch(svs.dispatch_batch(scores, noise))
    assert _worst_lsb(got, _whole_bucket(svs, scores, noise)) <= 1
    assert svs.decode_stats == {"calls": 1, "groups": 1,
                                "frames_padded": 4 * 128,
                                "frames_decoded": 4 * 128}


def test_decode_stats_count_every_call():
    """Three batched calls, on three threads as concurrent requests make
    them, each counted once."""
    svs = _svs("hifigan")
    batches = [_scores(svs, SPAN), _scores(svs, SHORT), _scores(svs, SPAN)]
    want = {"calls": 0, "groups": 0, "frames_padded": 0,
            "frames_decoded": 0}
    noises = []
    for scores in batches:
        noise = _noise(svs, scores)
        noises.append(noise)
        with torch.no_grad():
            _, mel_len, _ = svs._infer_hidden(scores, noise)
        groups = decode_groups(mel_len.numpy(), noise.shape[1],
                               svs.decode_halo)
        want["calls"] += 1
        want["groups"] += len(groups)
        want["frames_padded"] += noise.shape[0] * noise.shape[1]
        want["frames_decoded"] += sum(w * len(g) for w, g in groups)
    threads = [threading.Thread(target=lambda s=s, n=n: svs.collect_batch(
        svs.dispatch_batch(s, n))) for s, n in zip(batches, noises)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert svs.decode_stats == want


@pytest.mark.parametrize("halo,leaves", [(0, True), ("radius", False)])
def test_halo_decides_the_samples(monkeypatch, halo, leaves):
    """The comparison has teeth: cropped at mel_len exactly (a step of one
    frame, no halo) the last samples see the crop's zero padding and leave
    the whole bucket's decode; a halo of the decoder's receptive radius
    gives them back."""
    monkeypatch.setattr(synthesis, "DECODE_STEP", 1)
    svs = _svs("hifigan")
    svs.decode_halo = decoder_radius_frames(svs.cfg) if halo else 0
    scores = _scores(svs, SPAN)
    noise = _noise(svs, scores)
    got = svs.collect_batch(svs.dispatch_batch(scores, noise))
    worst = _worst_lsb(got, _whole_bucket(svs, scores, noise))
    assert (worst > 100) if leaves else (worst <= 1)


@pytest.mark.parametrize("name", sorted(RADIUS))
def test_radius_covers_the_published_decoders(name):
    """decoder_radius_frames at SVSConfig()'s structure (15, 14, 25
    frames; MB-iSTFT's reaches past the chunked decode's default halo of
    24) against the decoder itself: new hidden frames (and excitation)
    from mel_len + radius on leave every sample before mel_len * hop as it
    was, while new frames from mel_len + radius // 2 on move some."""
    kind = "hifigan" if name == "nsf" else name
    cfg = dataclasses.replace(NARROW, decoder_type=kind, nsf=name == "nsf")
    radius = decoder_radius_frames(cfg)
    assert radius == RADIUS[name]
    assert decoder_radius_frames(dataclasses.replace(
        SVSConfig(), decoder_type=kind)) == radius
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VISinger(cfg).eval()
    hop, frames, mel_len = cfg.hop_length, 96, 40
    gen = torch.Generator().manual_seed(1)
    hidden = torch.randn((1, frames, cfg.inter_channels), generator=gen)
    exc = (torch.randn((1, frames * hop, 1), generator=gen)
           if cfg.nsf else None)

    def kept(start):
        h = hidden.clone()
        h[:, start:] = torch.randn(h[:, start:].shape, generator=gen)
        e = None
        if exc is not None:
            e = exc.clone()
            e[:, start * hop:] = torch.randn(e[:, start * hop:].shape,
                                             generator=gen)
        with torch.no_grad():
            return model.decode_hidden(h, e)[0, : mel_len * hop, 0]

    with torch.no_grad():
        want = model.decode_hidden(hidden, exc)[0, : mel_len * hop, 0]
    peak = float(want.abs().max())
    assert peak > 0
    assert float((kept(mel_len + radius) - want).abs().max()) <= 1e-6 * peak
    assert float((kept(mel_len + radius // 2) - want).abs().max()) \
        > 1e-5 * peak


def test_healthz_reports_the_decode(tmp_path, monkeypatch):
    """/healthz sums every singer's decode_stats beside batching."""
    from music_generation_tpu_torch.serve.app import (MusicGenerationService,
                                                      make_http_server)
    monkeypatch.chdir(tmp_path)
    synths = {i: types.SimpleNamespace(decode_stats={
        "calls": 1 + i, "groups": 2 + i, "frames_padded": 1984 * 16,
        "frames_decoded": 640 * (i + 1)}) for i in range(3)}
    service = MusicGenerationService(
        types.SimpleNamespace(synthesizers=synths))
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            payload = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=60)
        service.close()
    assert not thread.is_alive()
    assert "batching" in payload
    assert payload["decode"] == {"calls": 6, "groups": 9,
                                 "frames_padded": 3 * 1984 * 16,
                                 "frames_decoded": 640 * 6}
