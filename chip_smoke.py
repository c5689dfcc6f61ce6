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
Launch counts are zeroed just before phase 3 and read after phase 4 (the
slice's main path; the lyric LMs launch no hand-written kernel). All phases
run in full float32: TF32 is off for matmuls and cuDNN convolutions. The
last stdout line is the result JSON; it is printed only when every phase
passed. Exits non-zero without a CUDA device.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from music_generation_tpu_torch.ops import build, maximum_path
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
    record["launches"] = maximum_path.kernel_launches
    if record["launches"] < 1 or maximum_path.plain_calls:
        raise AssertionError(f"main path launched the MAS kernel "
                             f"{record['launches']} times (plain calls "
                             f"{maximum_path.plain_calls})")

    rel = phase_gpu_vs_cpu(device)
    lyrics = phase_lyrics(device, t5_gen, gpt2_gen)
    log(json.dumps({"serve_latency_s": latencies,
                    "serve_keyword": keyword_rows, "serve_profile": breakdown,
                    "gpu_vs_cpu_rel": rel, "lyrics": lyrics},
                   ensure_ascii=False))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
