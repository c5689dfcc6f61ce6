#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (music_generation_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
  1. build    every CUDA kernel of csrc/ (one nvcc per source, in parallel)
  2. kernel   maximum_path (CUDA) vs maximum_path_torch (plain) on the card
              at the training shape [8, 480, 64], bit for bit, both timed;
              two edge shapes held bit for bit too
  3. align    full-width VISinger (SVSConfig()) MAS inputs -> the kernel via
              mas_duration_targets, held against the plain version
  4. serve    the port's HTTP server at full width (MelodyConfig(),
              SVSConfig(), three singers, the full-width T5 lyric LM as
              serve.app.main builds it): three song requests and three
              keyword requests, cold + warm, then one keyword request
              through the full-width GPT-2 LM; then one warm request's
              stage timings and device busy share
  5. gpu-cpu  one sentence through the full-width VISinger.infer on the card
              and on the CPU: same weights, noise and pinned durations
  6. lyrics   the full-width T5 and GPT-2 lyric LMs on the card against the
              CPU (same weights): teacher-forced logits, greedy decodes up
              to the first near tie; encode and per-token decode times,
              LyricGeneratorT5.generate's wall, launches per token and the
              device busy share under torch.profiler
  7. train    full-width GAN training steps (SVSConfig(), the full
              MultiPeriodDiscriminator, B=8, 64 phones, 480 frames,
              --durations mas) through the port's trainer: losses finite,
              weights moved, the MAS kernel launched twice per step and the
              plain version never; the kernel against the plain version on
              the neg_cent a step produced; one B=2 step on the card
              against the CPU (same weights and draws, dataset durations,
              dropout off): every loss term and every parameter gradient;
              warm ms per step, samples/s, peak memory and a profile
Launch counts are zeroed just before each main path and read just after
it: phases 3-4 (the served slices) and phase 7 (training; its count is
the one the kernels line reports). The lyric LMs launch no hand-written
kernel. All phases run in full float32: TF32 is off for matmuls and cuDNN
convolutions. The last stdout line is the result JSON; it is printed only
when every phase passed. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 0
MAS_SHAPE = (8, 480, 64)          # B, Ty (frames), Tx (phones)
# also held bit for bit: one to 32 columns per lane, a column count that is
# not a multiple of a warp,
# and the frame cap with enough phones to need > 48 KB of shared memory
EDGE_SHAPES = ((4, 60, 20), (4, 50, 45), (3, 1984, 200), (2, 1100, 1000))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                # H100 SXM float32 outside tensor cores
BENCH_SENTENCES = ["小小的天有大大的梦想", "重重的壳裹着轻轻的仰望",
                   "我知道我一直有双隐形的翅膀", "带我飞飞过绝望"]
REQUESTS = [
    {"text": "，".join(BENCH_SENTENCES)},
    {"text": "你好世界。隐形的翅膀带我飞过绝望", "singer_id": 1},
    {"text": "天空中的星星在闪烁，我们一起唱歌"},
]
KEYWORD_REQUESTS = [{"keyword": "夏天"}, {"keyword": "星空", "singer_id": 1},
                    {"theme": "离别"}]
LOGIT_REL_LIMIT = 1e-4    # card against CPU, teacher-forced, TF32 off
NEAR_TIE = 1e-3           # CPU top-two logit gap below which greedy may part
TRAIN_BATCH = 8           # the JAX trainer's --batch-size default
TRAIN_STEPS = 5           # warm, timed; after one cold step, before a
                          # profiled one
LOSS_REL_LIMIT = 1e-4     # card against CPU, each loss term
GRAD_REL_LIMIT = 1e-3     # card against the CPU's float64, each parameter
                          # gradient (L2), or 2x the CPU float32's error


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` warm CUDA-event timings of fn(), in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def mas_case(device, shape=MAS_SHAPE, seed=SEED):
    """Ragged MAS inputs: item 0 full, item 1 with t_x == t_y, the rest
    random lengths with t_y >= t_x."""
    import torch
    b, t_y, t_x = shape
    gen = torch.Generator(device).manual_seed(seed)
    neg_cent = torch.randn(shape, generator=gen, device=device) * 10.0
    rng = np.random.RandomState(seed)
    mask = torch.zeros(shape, device=device)
    lengths = [(t_y, t_x), (t_x, t_x)]
    for _ in range(b - 2):
        tx = int(rng.randint(2, t_x + 1))
        lengths.append((int(rng.randint(tx, t_y + 1)), tx))
    for i, (ty, tx) in enumerate(lengths):
        mask[i, :ty, :tx] = 1.0
    return neg_cent, mask, lengths


def mas_bound_ms(lengths) -> tuple[float, str]:
    """Least time for the card: inputs read once and the path written once,
    against the cells of the band this data fills (one add and one max
    each)."""
    b, t_y, t_x = MAS_SHAPE
    nbytes = 3 * b * t_y * t_x * 4
    cells = sum(sum(min(tx, y + 1) - max(0, tx + y - ty)
                    for y in range(ty)) for ty, tx in lengths)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * cells / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernel(device):
    import torch
    from music_generation_tpu_torch.ops import maximum_path, maximum_path_torch
    neg_cent, mask, lengths = mas_case(device)
    got = maximum_path(neg_cent, mask)
    want = maximum_path_torch(neg_cent, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("maximum_path kernel disagrees with the plain "
                             "version")
    if not torch.equal(got.sum(-1), mask[:, :, 0]):
        raise AssertionError("path is not one token per valid frame")
    diff = float((got - want).abs().max())
    for shape in EDGE_SHAPES:
        nc, m, _ = mas_case(device, shape, SEED + 3)
        if not torch.equal(maximum_path(nc, m), maximum_path_torch(nc, m)):
            raise AssertionError(f"maximum_path kernel disagrees with the "
                                 f"plain version at {list(shape)}")
    kernel_ms = cuda_ms(lambda: maximum_path(neg_cent, mask))
    plain_ms = cuda_ms(lambda: maximum_path_torch(neg_cent, mask))
    bound_ms, bound_by = mas_bound_ms(lengths)
    log(f"kernel phase: maximum_path == plain at {list(MAS_SHAPE)}, "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return {"name": "maximum_path", "route": "cuda",
            "source": "music_generation_tpu_torch/csrc/monotonic_align.cu",
            "replaces": "music_generation_tpu/ops/monotonic_align.py:99",
            "shape": list(MAS_SHAPE), "max_abs_err": diff,
            "max_abs_diff": diff, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_align(device):
    """Full-width MAS step: the tensors of visinger.py:524-534 (JAX
    package) from the port's own modules."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    from music_generation_tpu_torch.ops import (mas_duration_targets,
                                                mas_neg_cent,
                                                maximum_path_torch)
    b, frames, phones = MAS_SHAPE
    cfg = SVSConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = VISinger(cfg)
    model.to(device).eval()
    gen = torch.Generator(device).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    x_len = np.array([phones] + sorted(rng.randint(8, phones, b - 1))[::-1])
    y_len = np.array([frames] + [int(rng.randint(max(4 * n, 64), frames))
                                 for n in x_len[1:]])

    def ids(hi):
        return torch.from_numpy(rng.randint(1, hi, (b, phones))).to(device)

    spec = torch.randn((b, frames, cfg.spec_channels), generator=gen,
                       device=device).abs()
    durs = torch.from_numpy(rng.uniform(0.1, 0.5, (b, phones)).astype(
        np.float32)).to(device)
    t0 = time.time()
    with torch.no_grad():
        inputs = model.mas_inputs(
            ids(60), torch.from_numpy(x_len).to(device), ids(90), durs,
            ids(240), spec, torch.from_numpy(y_len).to(device),
            generator=gen)
        dur = mas_duration_targets(*inputs)
        torch.cuda.synchronize()
        align_s = time.time() - t0
        neg_cent, attn = mas_neg_cent(*inputs)
        plain = maximum_path_torch(neg_cent, attn).sum(1).to(torch.int32)
    dur_np = dur.cpu().numpy()
    if not np.array_equal(dur_np.sum(1), y_len):
        raise AssertionError(f"durations {dur_np.sum(1)} != frames {y_len}")
    if not torch.equal(dur, plain):
        raise AssertionError("MAS durations differ from the plain version")
    log(f"align phase: full-width SVSConfig() MAS at B={b}, {phones} phones, "
        f"{frames} frames: durations sum to frame lengths, equal to plain; "
        f"{align_s:.3f} s")


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesis_music",
        data=json.dumps(payload, ensure_ascii=False).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def profiled(fn) -> dict:
    """fn() under torch.profiler: its wall, the device's busy time and
    share, the kernel launches and the heaviest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        profiled_s = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"profiled_s": profiled_s, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / profiled_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def profile_request(songs, text: str) -> dict:
    """Where one warm request's time goes: SongSynthesizer's stage timings
    (unprofiled), then the same request under torch.profiler."""
    timings = songs.synthesize_song(text).timings
    return {"melody_s": timings["melody_s"], "svs_s": timings["svs_s"],
            "total_s": timings["total_s"],
            **profiled(lambda: songs.synthesize_song(text))}


class StageClock:
    """A lyric generator that records the seconds of each generate()."""

    def __init__(self, generator):
        self.generator = generator
        self.seconds = []

    def generate(self, keyword: str) -> str:
        t0 = time.time()
        text = self.generator.generate(keyword)
        self.seconds.append(time.time() - t0)
        return text


def check_song(tag: str, out: dict) -> float:
    """A 200 answer's WAV: 22,050 Hz int16, finite, not only the pad.
    Returns its seconds of audio."""
    from scipy.io import wavfile
    if out.get("code") != 200 or not out["data"]["lyrics"]:
        raise AssertionError(f"{tag}: {out}")
    rate, wav = wavfile.read(io.BytesIO(
        base64.b64decode(out["data"]["audio"])))
    pad = int(0.2 * 22050)
    if rate != 22050 or wav.dtype != np.int16:
        raise AssertionError(f"{tag}: rate {rate} {wav.dtype}")
    if len(wav) <= pad or not np.any(wav[pad:] != 0):
        raise AssertionError(f"{tag}: {len(wav)} samples, silent or only "
                             "the pad")
    if not np.isfinite(wav.astype(np.float64)).all():
        raise AssertionError(f"{tag}: non-finite samples")
    return len(wav) / rate


def keyword_requests(port, clock) -> list:
    """The T5 keyword requests, cold and warm: each answers 200 with its
    lyrics and a song, or 202 (empty or over-long lyrics). At least three
    must answer 200."""
    rows = []
    for i, payload in enumerate(KEYWORD_REQUESTS):
        for kind in ("cold", "warm"):
            t0 = time.time()
            out = _post(port, payload)
            row = {"keyword_request": i, "kind": kind,
                   "singer_id": payload.get("singer_id", 0),
                   "code": out.get("code"), "latency_s": time.time() - t0,
                   "lyric_s": clock.seconds[-1]}
            if out.get("code") == 200:
                row["lyric_chars"] = len(out["data"]["lyrics"])
                row["audio_s"] = check_song(f"keyword request {i}", out)
            elif out.get("code") != 202:
                raise AssertionError(f"keyword request {i}: {out}")
            rows.append(row)
            log("serve keyword request: " + json.dumps(row,
                                                       ensure_ascii=False))
    n_ok = sum(r["code"] == 200 for r in rows)
    if n_ok < 3:
        raise AssertionError(f"only {n_ok} T5 keyword requests answered 200")
    return rows


def phase_serve(device, t5_gen, gpt2_gen):
    import torch
    from music_generation_tpu_torch.config import ServiceConfig
    from music_generation_tpu_torch.pipeline import (
        build_default_song_synthesizer)
    from music_generation_tpu_torch.serve.app import (MusicGenerationService,
                                                      make_http_server)
    t0 = time.time()
    songs = build_default_song_synthesizer(tiny=False, n_speakers=3,
                                           seed=SEED, device=device)
    log(f"serve phase: full-width pipeline built in {time.time() - t0:.1f} s")
    cfg = ServiceConfig(log_dir="logs")
    clock = StageClock(t5_gen)
    service = MusicGenerationService(songs, clock, cfg)
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies = []
    try:
        port = server.server_address[1]
        for i, payload in enumerate(REQUESTS):
            row = {"request": i, "singer_id": payload.get("singer_id", 0),
                   "chars": len(payload["text"])}
            for kind in ("cold", "warm"):
                t1 = time.time()
                out = _post(port, payload)
                row[f"{kind}_s"] = time.time() - t1
                row["audio_s"] = check_song(f"request {i}", out)
            latencies.append(row)
            log(f"serve request {i}: " + json.dumps(row, ensure_ascii=False))
        keyword_rows = keyword_requests(port, clock)
        # the same server with the GPT-2 LM (serve.app --lyric-model gpt2)
        service.lyrics = clock = StageClock(gpt2_gen)
        t1 = time.time()
        out = _post(port, {"keyword": "夏天"})
        row = {"keyword_request": "gpt2", "code": out.get("code"),
               "latency_s": time.time() - t1, "lyric_s": clock.seconds[-1]}
        if out.get("code") == 200:
            row["lyrics"] = out["data"]["lyrics"]
            row["audio_s"] = check_song("gpt2 keyword request", out)
        elif out.get("code") == 202:
            row["why"] = "the generated lyrics were empty or over 500 chars"
        else:
            raise AssertionError(f"gpt2 keyword request: {out}")
        keyword_rows.append(row)
        log("serve keyword request: " + json.dumps(row, ensure_ascii=False))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    breakdown = profile_request(songs, REQUESTS[0]["text"])
    log("serve profile: " + json.dumps(breakdown, ensure_ascii=False))
    del songs
    torch.cuda.empty_cache()
    return latencies, keyword_rows, breakdown


def phase_gpu_vs_cpu(device):
    import torch
    from music_generation_tpu_torch.frontend import ScoreFrontend
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    cfg = SVSConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 2)
        cpu_model = VISinger(cfg).eval()
    gpu_model = VISinger(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(device).eval()
    score = ScoreFrontend().align("带我飞过绝望AP",
                                  ["C4", "D4", "E4", "F4", "G4", "A4", "rest"],
                                  [0.3] * 6 + [0.6])
    n = len(score.phone_ids)
    rng = np.random.RandomState(SEED + 2)
    ph_dur = rng.randint(3, 9, (1, n)).astype(np.int32)
    max_frames = 128
    noise = rng.randn(1, max_frames, cfg.inter_channels).astype(np.float32)
    args = [torch.from_numpy(np.asarray(a)[None]) for a in
            (score.phone_ids, [n], score.note_ids, score.note_durations,
             score.shengdiao_ids)]
    args[1] = args[1][0]
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, device)):
        with torch.no_grad():
            audio, mel_len, _ = model.infer(
                *[a.to(dev) for a in args], max_frames,
                ph_dur=torch.from_numpy(ph_dur).to(dev),
                noise=torch.from_numpy(noise).to(dev))
        n_samples = int(mel_len[0]) * cfg.hop_length
        outs.append(audio[0, :n_samples, 0].double().cpu().numpy())
    cpu, gpu = outs
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu))
    log(f"gpu-vs-cpu phase: full-width VISinger.infer, {len(cpu)} samples, "
        f"relative L2 error {rel:.3e} (TF32 off)")
    if not np.isfinite(gpu).all() or not rel <= 1e-4:
        raise AssertionError(f"GPU vs CPU relative error {rel}")
    return rel


def rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def first_near_tie(logits, buf, steps):
    """The first decode step whose CPU logits (logits[:, step], with the
    bigram ban of the token buffer ``buf`` applied as the decode applies
    it) hold their top two within NEAR_TIE of each other, else None."""
    from music_generation_tpu_torch.models.lyrics.gpt2 import (
        _ban_repeated_bigrams)
    for pos in steps:
        top = _ban_repeated_bigrams(logits[:, pos], buf, pos,
                                    logits.shape[-1]).topk(2).values[0]
        if float(top[0] - top[1]) < NEAR_TIE:
            return pos
    return None


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() between two device syncs."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def t5_on_card_and_cpu(device, t5_gen, budget: int) -> dict:
    """Full-width T5: teacher-forced logits and the top_k=1 decode of the
    default prompt on the card against a CPU copy of the same weights."""
    import torch
    from music_generation_tpu_torch.models.lyrics import topk_sample_generate
    gpu = t5_gen.model
    cpu = copy.deepcopy(gpu).cpu()
    cfg = gpu.cfg
    src = torch.tensor([t5_gen.prompt_ids("夏天")])
    mask = torch.ones_like(src)
    with torch.no_grad():
        cpu_tok = topk_sample_generate(cpu, torch.Generator(), src, mask,
                                       max_length=budget, top_k=1)
        gpu_tok = topk_sample_generate(
            gpu, torch.Generator(device), src.to(device), mask.to(device),
            max_length=budget, top_k=1).cpu()
        buf = torch.cat([torch.full((1, 1), cfg.decoder_start_token_id),
                         cpu_tok], 1)
        cpu_logits = cpu(src, mask, buf[:, :-1])
        gpu_logits = gpu(src.to(device), mask.to(device),
                         buf[:, :-1].to(device))
    del cpu
    row = cpu_tok[0].tolist()
    eos = row.index(cfg.eos_token_id) if cfg.eos_token_id in row else None
    end = budget if eos is None else eos + 1    # pad after EOS
    tie = first_near_tie(cpu_logits, buf, range(end))
    upto = end if tie is None else tie
    rel = rel_l2(gpu_logits, cpu_logits)
    same = torch.equal(gpu_tok[:, :upto], cpu_tok[:, :upto])
    log(f"lyrics phase: T5 teacher-forced logits [1, {budget}, "
        f"{cfg.vocab_size}] card vs CPU relative L2 {rel:.3e}; top_k=1 "
        f"decode identical over {upto} of {budget} steps "
        f"(first near tie: {tie}, EOS step: {eos})")
    if not rel <= LOGIT_REL_LIMIT or not same:
        raise AssertionError(f"T5 card vs CPU: rel {rel}, tokens equal "
                             f"up to step {upto}: {same}")
    return {"logits_rel_l2": rel, "steps_compared": upto,
            "first_near_tie": tie, "src": src.to(device),
            "mask": mask.to(device)}


def gpt2_on_card_and_cpu(device, gpt2_gen) -> dict:
    """Full-width GPT-2: teacher-forced logits and greedy_generate on the
    card against a CPU copy of the same weights."""
    import torch
    from music_generation_tpu_torch.models.lyrics import greedy_generate
    from music_generation_tpu_torch.models.lyrics.api import GPT2_MAX_LENGTH
    tok = gpt2_gen.tokenizer
    gpu = gpt2_gen.model
    cpu = copy.deepcopy(gpu).cpu()
    prompt = ([tok.cls_id] + tok.encode("夏天")
              + [tok.sep_id, tok.token_id("<Pop 流行>"), tok.sep_id])
    buf = torch.full((1, GPT2_MAX_LENGTH), tok.pad_id, dtype=torch.int64)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    plen = torch.tensor([len(prompt)])
    with torch.no_grad():
        cpu_buf = greedy_generate(cpu, buf, plen, GPT2_MAX_LENGTH)
        gpu_buf = greedy_generate(gpu, buf.to(device), plen,
                                  GPT2_MAX_LENGTH).cpu()
        cpu_logits = cpu(cpu_buf)
        gpu_logits = gpu(cpu_buf.to(device))
    del cpu
    tie = first_near_tie(cpu_logits, cpu_buf,
                         range(len(prompt) - 1, GPT2_MAX_LENGTH - 1))
    upto = GPT2_MAX_LENGTH if tie is None else tie + 1
    rel = rel_l2(gpu_logits, cpu_logits)
    same = torch.equal(gpu_buf[:, :upto], cpu_buf[:, :upto])
    log(f"lyrics phase: GPT-2 teacher-forced logits [1, {GPT2_MAX_LENGTH}, "
        f"{gpu.cfg.vocab_size}] card vs CPU relative L2 {rel:.3e}; greedy "
        f"buffer identical over {upto} of {GPT2_MAX_LENGTH} positions "
        f"(first near tie: {tie})")
    if not rel <= LOGIT_REL_LIMIT or not same:
        raise AssertionError(f"GPT-2 card vs CPU: rel {rel}, tokens equal "
                             f"up to {upto}: {same}")
    return {"logits_rel_l2": rel, "positions_compared": upto,
            "first_near_tie": tie, "buf": buf.to(device), "plen": plen}


def phase_lyrics(device, t5_gen, gpt2_gen) -> dict:
    import torch
    from music_generation_tpu_torch.models.lyrics import (greedy_generate,
                                                          topk_sample_generate)
    from music_generation_tpu_torch.models.lyrics.api import (GPT2_MAX_LENGTH,
                                                              T5_TOP_K)
    budget = 120  # LyricGeneratorT5's default: min(512, max(48, 8 * 15))
    t5 = t5_on_card_and_cpu(device, t5_gen, budget)
    gpt2 = gpt2_on_card_and_cpu(device, gpt2_gen)
    src, mask = t5.pop("src"), t5.pop("mask")
    buf, plen = gpt2.pop("buf"), gpt2.pop("plen")
    gpu_t5, gpu_gpt2 = t5_gen.model, gpt2_gen.model
    gpt2_steps = GPT2_MAX_LENGTH - 1

    def t5_decode():
        topk_sample_generate(gpu_t5, t5_gen.generator, src, mask,
                             max_length=budget, top_k=T5_TOP_K)

    def gpt2_decode():
        greedy_generate(gpu_gpt2, buf, plen, GPT2_MAX_LENGTH)

    with torch.no_grad():
        t5["encode_ms"] = cuda_ms(lambda: gpu_t5.encode(src, mask))
    t5["decode_ms"] = host_ms(t5_decode)
    t5["ms_per_token"] = (t5["decode_ms"] - t5["encode_ms"]) / budget
    gpt2["decode_ms"] = host_ms(gpt2_decode)
    gpt2["ms_per_token"] = gpt2["decode_ms"] / gpt2_steps
    walls = []
    for _ in range(3):
        t0 = time.time()
        t5_gen.generate("夏天")
        walls.append(time.time() - t0)
    t5["generate_wall_s"] = float(np.median(walls))
    for rec, fn, steps in ((t5, t5_decode, budget),
                           (gpt2, gpt2_decode, gpt2_steps)):
        rec["profile"] = profiled(fn)
        rec["launches_per_token"] = rec["profile"]["kernel_launches"] / steps
    log(f"lyrics phase: T5 encode {t5['encode_ms']:.3f} ms, "
        f"{t5['ms_per_token']:.3f} ms per decode token, generate wall "
        f"{t5['generate_wall_s']:.4f} s for {budget} tokens, "
        f"{t5['launches_per_token']:.1f} launches per token, device busy "
        f"{t5['profile']['device_busy_share']:.3f}; GPT-2 "
        f"{gpt2['ms_per_token']:.3f} ms per token, "
        f"{gpt2['launches_per_token']:.1f} launches per token, device busy "
        f"{gpt2['profile']['device_busy_share']:.3f}")
    return {"t5": t5, "gpt2": gpt2}


def grads_close(card: dict, cpu: dict, exact: dict) -> tuple[dict, list]:
    """Hold each float32 gradient of the card against the float64 CPU
    gradient ``exact``: within GRAD_REL_LIMIT relative L2, or no more
    than twice as far from it as the CPU's own float32 gradient ``cpu``.
    (At this random init the decoder's and the spec decoder's gradients
    are ill-conditioned in float32: the CPU's float32 misses float64 by up
    to 0.5 % there too.) Attention key biases have an exact gradient of
    zero (softmax ignores a shift shared by all of a query's scores), so
    both sides hold rounding only: held within 1e-6 of the largest
    gradient norm. A gradient that is exactly zero on the CPU (behind the
    zero-initialised flow projections) must be zero on the card.
    Returns the worst errors and the tensors that failed."""
    scale = max(float(w.norm()) for w in exact.values())
    worst = {"card_vs_f64": 0.0, "cpu_vs_f64": 0.0, "card_vs_cpu": 0.0}
    failed = []
    for name, w in exact.items():
        g, c = card[name].double(), cpu[name].double()
        if not c.any():
            if g.any():
                failed.append((name, "zero on the CPU, not on the card"))
            continue
        if name.endswith(".k.bias"):
            if not float((g - w).norm()) <= 1e-6 * scale:
                failed.append((name, float((g - w).norm())))
            continue
        errs = {"card_vs_f64": float((g - w).norm() / w.norm()),
                "cpu_vs_f64": float((c - w).norm() / w.norm()),
                "card_vs_cpu": float((g - c).norm() / c.norm())}
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        if not errs["card_vs_f64"] <= max(GRAD_REL_LIMIT,
                                          2 * errs["cpu_vs_f64"]):
            failed.append((name, errs))
    return worst, failed


def train_loss_and_grads(device, controls=None) -> dict:
    """One full-width B=2 generator and discriminator loss and gradient,
    dataset durations, dropout off, the same weights and draws: on the
    CPU in float32 (``cpu``) and float64 (``cpu_f64``) and on the card in
    float32 (``card``). ``controls`` maps more card tags to (context
    manager factory, whole): entered around the whole computation when
    ``whole``, else around the generator forward only (its outputs are
    cast back to float32). Returns tag -> (loss terms, gradients on the
    CPU)."""
    import contextlib
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.train import (TrainConfig, create_states,
                                                  synthetic_batch, to_device,
                                                  tool_shapes, trainer)
    cfg, tc = SVSConfig(), TrainConfig()
    phones, frames = tool_shapes(False)
    cpu_gen, cpu_disc = (s.model for s in create_states(cfg, tc, "cpu"))
    batch = synthetic_batch(cfg, batch=2, t_phones=phones, t_frames=frames,
                            seed=SEED + 5)
    rng = np.random.RandomState(SEED + 5)
    shape = (2, frames, cfg.inter_channels)
    draws = {"noise": rng.randn(*shape), "noise_rev": rng.randn(*shape),
             "slice_u": rng.uniform(0, 1, 2).astype(np.float32)}
    plain = (contextlib.nullcontext, True)
    runs = [("cpu", "cpu", torch.float32, plain),
            ("cpu_f64", "cpu", torch.float64, plain),
            ("card", device, torch.float32, plain)]
    runs += [("card_" + tag, device, torch.float32, control)
             for tag, control in (controls or {}).items()]
    results = {}
    for tag, dev, dtype, (ctx, whole) in runs:
        gen = copy.deepcopy(cpu_gen).to(dev, dtype)
        disc = copy.deepcopy(cpu_disc).to(dev, dtype)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(batch, dev).items()}
        with ctx() if whole else contextlib.nullcontext():
            with contextlib.nullcontext() if whole else ctx():
                out = trainer.gen_forward(gen, b, tc, deterministic=True, **{
                    k: torch.from_numpy(v).to(
                        dev, dtype if k != "slice_u" else torch.float32)
                    for k, v in draws.items()})
            out = {k: v.to(dtype) if v.is_floating_point() else v
                   for k, v in out.items()}
            total, metrics = trainer.generator_loss(disc, out, b, cfg, tc)
            g_names = [n for n, _ in gen.named_parameters()]
            g_grads = torch.autograd.grad(total, list(gen.parameters()))
            d_loss = trainer.discriminator_loss(disc, out, b, cfg, tc)
            d_names = [n for n, _ in disc.named_parameters()]
            d_grads = torch.autograd.grad(d_loss, list(disc.parameters()))
        metrics["loss_disc"] = d_loss.detach()
        results[tag] = (
            {k: float(v) for k, v in metrics.items()
             if k.startswith("loss_")},
            {f"gen.{n}": g.cpu() for n, g in zip(g_names, g_grads)}
            | {f"disc.{n}": g.cpu() for n, g in zip(d_names, d_grads)})
        del gen, disc, out, total, g_grads, d_grads
    return results


def judge_train_step(results: dict, card: str = "card") -> dict:
    """Each of ``card``'s loss terms against the CPU's float32 one (within
    LOSS_REL_LIMIT), each gradient as grads_close holds it."""
    cpu_loss = results["cpu"][0]
    loss_rel = {k: abs(results[card][0][k] - v) / abs(v)
                for k, v in cpu_loss.items()}
    worst, grads_failed = grads_close(results[card][1], results["cpu"][1],
                                      results["cpu_f64"][1])
    return {"loss_rel": loss_rel, "grad_worst_rel_l2": worst,
            "n_grad_tensors": len(results["cpu"][1]),
            "losses_failed": sorted(k for k, v in loss_rel.items()
                                    if not v <= LOSS_REL_LIMIT),
            "grads_failed": grads_failed}


def train_step_on_card_and_cpu(device) -> dict:
    """One full-width B=2 step's loss terms on the card against the CPU's
    float32 ones, and its gradients against the CPU's float64 ones (see
    train_loss_and_grads, judge_train_step). MAS is kept out: card and
    CPU round neg_cent differently, so a near tie may flip the path."""
    rep = judge_train_step(train_loss_and_grads(device))
    if rep["losses_failed"]:
        raise AssertionError(f"card vs CPU loss terms: "
                             f"{rep['losses_failed']} {rep['loss_rel']}")
    if rep["grads_failed"]:
        raise AssertionError(f"card gradients: {rep['grads_failed']}")
    worst = rep["grad_worst_rel_l2"]
    log(f"train phase: full-width B=2 step, card vs CPU: "
        f"{len(rep['loss_rel'])} loss terms, worst relative error "
        f"{max(rep['loss_rel'].values()):.3e}; {rep['n_grad_tensors']} "
        f"gradient tensors, worst relative L2 against float64: card "
        f"{worst['card_vs_f64']:.3e}, CPU float32 {worst['cpu_vs_f64']:.3e} "
        f"(card vs CPU {worst['card_vs_cpu']:.3e})")
    return {k: rep[k] for k in ("loss_rel", "grad_worst_rel_l2",
                                "n_grad_tensors")}


def phase_train(device) -> dict:
    """Full-width GAN training steps with MAS durations through the port's
    trainer API (the main path of this slice)."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.ops import (maximum_path,
                                                maximum_path_torch,
                                                monotonic_align)
    from music_generation_tpu_torch.train import (TrainConfig, create_states,
                                                  make_train_step,
                                                  synthetic_batch, to_device,
                                                  tool_shapes)
    cfg = SVSConfig()
    tc = TrainConfig(use_mas=True, warmup_steps=0)
    phones, frames = tool_shapes(False)
    t0 = time.time()
    gen_state, disc_state = create_states(cfg, tc, device)
    step = make_train_step(cfg, tc)
    generator = torch.Generator(device).manual_seed(SEED)
    n_steps = TRAIN_STEPS + 2
    batches = [to_device(synthetic_batch(cfg, batch=TRAIN_BATCH,
                                         t_phones=phones, t_frames=frames,
                                         seed=i), device)
               for i in range(n_steps)]
    n_params = [sum(p.numel() for p in s.model.parameters())
                for s in (gen_state, disc_state)]
    before = {f"{tag}.{n}": p.detach().clone()
              for tag, s in (("gen", gen_state), ("disc", disc_state))
              for n, p in s.model.named_parameters()}
    torch.cuda.synchronize()
    log(f"train phase: full-width states built in {time.time() - t0:.1f} s "
        f"(generator {n_params[0]:,}, discriminator {n_params[1]:,} "
        f"parameters)")

    # the neg_cent and mask of the first MAS call of the first step
    live = []
    neg_cent_fn = monotonic_align.mas_neg_cent

    def capture(*args, **kwargs):
        out = neg_cent_fn(*args, **kwargs)
        if not live:
            live.append(tuple(x.clone() for x in out))
        return out

    rows = []

    def run(i):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(gen_state, disc_state, batches[i], generator)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {i}: {values}")
        rows.append({"step": i, "ms": ms, **values})

    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    monotonic_align.mas_neg_cent = capture
    try:
        run(0)
    finally:
        monotonic_align.mas_neg_cent = neg_cent_fn
    # every submodule of both models moved in the first step
    moved = {}
    for tag, s in (("gen", gen_state), ("disc", disc_state)):
        for n, p in s.model.named_parameters():
            key = f"{tag}.{n}"
            sub = ".".join(key.split(".")[:2])
            moved[sub] = moved.get(sub, 0) + (not torch.equal(before[key], p))
    del before
    still = sorted(k for k, v in moved.items() if not v)
    if still:
        raise AssertionError(f"no parameter of {still} moved in step 1")
    for i in range(1, TRAIN_STEPS + 1):
        run(i)
    peak = torch.cuda.max_memory_allocated()
    prof = profiled(lambda: run(TRAIN_STEPS + 1))
    launches = maximum_path.kernel_launches
    if launches != 2 * n_steps or maximum_path.plain_calls:
        raise AssertionError(
            f"{n_steps} training steps launched the MAS kernel {launches} "
            f"times (plain calls {maximum_path.plain_calls}); want "
            f"{2 * n_steps} and 0")

    # the kernel against the plain version on the step's own neg_cent
    neg_cent, attn = live[0]
    got = maximum_path(neg_cent, attn)
    want = maximum_path_torch(neg_cent, attn)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("maximum_path kernel disagrees with the plain "
                             "version on a training step's neg_cent")
    warm = [r["ms"] for r in rows[1:TRAIN_STEPS + 1]]
    ms = float(np.median(warm))
    result = {"cold_ms": rows[0]["ms"], "warm_ms": warm,
              "ms_per_step": ms,
              "samples_per_s": TRAIN_BATCH / ms * 1e3,
              "peak_memory_bytes": peak, "resident_bytes_before": resident,
              "mas_launches": launches, "live_neg_cent_shape":
              list(neg_cent.shape), "profile": prof,
              "losses_first_last": [
                  {k: v for k, v in rows[j].items() if k.startswith("loss")}
                  for j in (0, -1)]}
    log(f"train phase: {n_steps} full-width steps (B={TRAIN_BATCH}, "
        f"{phones} phones, {frames} frames, MAS): cold {rows[0]['ms']:.1f} "
        f"ms, warm {ms:.1f} ms per step, {result['samples_per_s']:.2f} "
        f"samples/s, peak memory {peak / 2 ** 30:.2f} GiB; MAS kernel "
        f"{launches} launches, plain 0; kernel == plain on the step's "
        f"neg_cent {list(neg_cent.shape)}; profiled step: device busy "
        f"{prof['device_busy_share']:.3f}, {prof['kernel_launches']} "
        f"launches")
    del gen_state, disc_state, batches, live
    torch.cuda.empty_cache()
    result["gpu_vs_cpu"] = train_step_on_card_and_cpu(device)
    return result


def phases_before_train(device) -> dict:
    """Phases 2-6: the kernel's record, then the served slices (their MAS
    launches counted), the card against the CPU and the lyric LMs."""
    import torch
    from music_generation_tpu_torch.ops import maximum_path
    record = phase_kernel(device)

    from music_generation_tpu_torch.models.lyrics import build_lyric_generator
    t0 = time.time()
    t5_gen = build_lyric_generator("t5", seed=SEED, device=device)
    gpt2_gen = build_lyric_generator("gpt2", seed=SEED, device=device)
    n_t5, n_gpt2 = (sum(p.numel() for p in g.model.parameters())
                    for g in (t5_gen, gpt2_gen))
    log(f"lyric LMs built in {time.time() - t0:.1f} s: T5 {n_t5:,} "
        f"parameters, GPT-2 {n_gpt2:,} parameters")

    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    phase_align(device)
    latencies, keyword_rows, breakdown = phase_serve(device, t5_gen,
                                                     gpt2_gen)
    if maximum_path.kernel_launches < 1 or maximum_path.plain_calls:
        raise AssertionError(f"main path launched the MAS kernel "
                             f"{maximum_path.kernel_launches} times (plain "
                             f"calls {maximum_path.plain_calls})")

    rel = phase_gpu_vs_cpu(device)
    lyrics = phase_lyrics(device, t5_gen, gpt2_gen)
    del t5_gen, gpt2_gen
    torch.cuda.empty_cache()
    return {"record": record, "serve_latency_s": latencies,
            "serve_keyword": keyword_rows, "serve_profile": breakdown,
            "gpu_vs_cpu_rel": rel, "lyrics": lyrics}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from music_generation_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    build.build_all()
    log(f"build phase: {build.kernel_sources()} in {time.time() - t0:.1f} s")

    earlier = phases_before_train(device)
    train = phase_train(device)
    record = earlier.pop("record")
    record["launches"] = train["mas_launches"]
    log(json.dumps(earlier | {"train": train}, ensure_ascii=False))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
