#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (music_generation_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
  1. build    every CUDA kernel of csrc/ (one nvcc per source, in parallel)
  2. kernel   maximum_path (CUDA) vs maximum_path_torch (plain) on the card
              at the training shape [8, 480, 64], bit for bit, both timed;
              two edge shapes held bit for bit too
 2b. shapes   maximum_path through the entry point at the shapes the warp
              variant refuses and the JAX package aligns, [2, 20000, 64]
              (decision bits past the warp variant's shared memory),
              [4, 8000, 256] (ragged, one item of more phones than
              frames) and [1, 3000, 1500] (Tx > 1024), then [8, 480, 64]
              (the warp variant): one launch each, the variant mas_plan
              picks, the plain version never; each path bit for bit the
              plain version's, one token per valid frame; kernel ms (CUDA
              events, median of 10 warm runs), the plain version's ms (one
              run), the bound (bytes or the function's dependent chain;
              the chosen design's chain beside it); then the wide
              variant alone at every K, 1 to 8 warps and two strips
              against the plain version
  3. align    full-width VISinger (SVSConfig()) MAS inputs -> the kernel via
              mas_duration_targets, held against the plain version
  4. serve    the port's HTTP server at full width (MelodyConfig(),
              SVSConfig(), three singers, the full-width T5 lyric LM as
              serve.app.main builds it): three song requests and three
              keyword requests, cold + warm, then one keyword request
              through the full-width GPT-2 LM; then one warm request's
              stage timings and device busy share
  5. variants serve.app's svs_v5_multispeaker (MelodyConfig() with SDP
              durations, SDPDurationConfig()) and melody_v2 (three
              Seq2SeqConfig() GRU models, beam 5) around the serve phase's
              three SVS synthesizers: one cold and two warm text requests
              each (a comma fragment, a line over 6 characters, both svs_v5
              phrase substitutions), every sentence's notes and durations
              checked; the SDP raw durations (same injected noise) and the
              seq2seq teacher-forced log-probs on the card against CPU
              twins of the same weights, get_melody identical up to the
              CPU's first near tie; a warm request's stage timings and
              launches
  6. gpu-cpu  one sentence through the full-width VISinger.infer on the card
              and on the CPU: same weights, noise and pinned durations
  7. lyrics   the full-width T5 and GPT-2 lyric LMs on the card against the
              CPU (same weights): teacher-forced logits, greedy decodes up
              to the first near tie; encode and per-token decode times,
              LyricGeneratorT5.generate's wall, launches per token and the
              device busy share under torch.profiler
  8. train    full-width GAN training steps (SVSConfig(), the full
              MultiPeriodDiscriminator, B=8, 64 phones, 480 frames,
              --durations mas) through the port's trainer: losses finite,
              weights moved, the MAS kernel launched twice per step and the
              plain version never; the kernel against the plain version on
              the neg_cent a step produced; one B=2 step on the card
              against the CPU (same weights and draws, dataset durations,
              dropout off): every loss term and every parameter gradient;
              warm ms per step, samples/s, peak memory and a profile
  9. checkpoint  the trained full-width generator through save_checkpoint
              and tools/torch_export_trained_svs.py to svs_0..2, served by
              serve.app's construction (configure + build_songs) with
              --checkpoint-dir: one text request over HTTP, every served
              tensor equal to the trained generator's, the decoder off its
              init; the serve phase's pipeline (save_pipeline) loaded into
              songs from another seed: every state_dict equal, melody
              included
 10. decoders serve.app --decoder istft and mb_istft at full width (the
              server's construction): one text request cold and twice
              warm, a warm request's stage timings and launches;
              VISinger.infer on the card against the CPU; the decoder alone
              against the HiFi-GAN decoder on the same hidden state; three
              full-width training steps with --durations mas (MAS kernel
              twice per step, the plain version never), ms per warm step
              and peak memory
 11. f0 variants  three full-width training steps with --nsf --f0-residual
              and --durations mas (MAS twice per step, held bit for bit
              against the plain version on a step's neg_cent; warm ms,
              peak memory, the excitation's own ms); that generator through
              save_checkpoint and the export tool (--nsf --f0-residual) into
              serve.app --checkpoint-dir --nsf --f0-residual, every served
              tensor equal (exc convs included); four served
              configurations (--nsf --f0-residual on those weights, --nsf
              --f0 score, --decoder-bf16, --decoder-bf16 --decoder
              mb_istft): one text request cold and twice warm, a warm
              request's stage timings and launches; the NSF ones on their
              served scores card against CPU: infer_hidden, the
              excitation's phase against float64 within a derived bound,
              the decoder fed the CPU's inputs, the voiced masks, a voiced
              share over one half; under --f0 score log_f0_used equal to
              the score's pitch; the HiFi-GAN decoder alone in float32,
              bf16 (held to the relative-MAE bound) and with NSF
 12. served surface  serve.app's build_service with --fused --warmup at
              full width (build and warm-up seconds): a lone request cold
              and twice warm on the fused path (the service's path
              counter); two concurrent requests, while a third holds the
              fused path, on the staged path through the batcher
              (/healthz); POST /synthesis_music_stream parsed chunk by
              chunk (seconds to the first audio chunk and the last, chunk
              count, PCM length equal to the staged song's); the fused
              notes and per-sentence samples equal to the staged path's,
              pinned 0.5 s syllables over 1.5x the samples of 0.2 s; a warm
              request of each path profiled (wall, launches, busy share)
              and its synchronising CUDA calls counted
              (torch.cuda.set_sync_debug_mode); stream_score against the
              monolithic decode of the same prior noise (1 LSB, peak over
              1000 LSB); the chunked batch decode (64 frames, halo 24)
              against the monolithic one (1 LSB, float within 1e-5 of the
              peak), plain and under --nsf --f0 score; the HiFi-GAN's
              receptive field in frames against the halo; peak memory of a
              16-sentence batch at the 1984-frame bucket, monolithic and
              chunked
 13. v1_model and SVS probes  serve.app --variant v1_model at full width
              (two MelodyConfig() TeleMelody twins, top-k sampled decodes,
              the three SVSConfig() singers of the serve phase's seed, the
              rendered MIDI accompaniment mixed under the vocal): a
              4-sentence text cold and twice warm over HTTP, a warm
              request's stage timings (the accompaniment's own), launches
              and busy share; the mixed song against the same request's
              vocal alone (same length and notes, other samples); the twins
              on the card against the CPU (teacher-forced log-probs,
              get_melody on shared Gumbel draws, tokens equal up to the
              CPU's first near tie); the CLI's --score at full width;
              infer_fake, copy_synthesis and voice_conversion (gin 256,
              g_src != g_tgt) on [2, 512, 513] card against CPU, and
              g_src == g_tgt giving z back; SVSConfig(autoencoder=False)
              infer card against CPU; a plain reference .pth written from
              random weights through tools/torch_import_pipeline.py --pth
              --no-autoencoder into --checkpoint-dir, every served tensor
              equal to the file's, one request served; one plain full-width
              training step with --durations mas (MAS twice, no loss_spec)
 14. corpus and v1  the port's native host library built with g++ into
              build/music_generation_tpu_torch/ (native_available, build
              seconds, with or without OpenMP); two toy corpora written and
              preprocessed (YIN through the native code, asserted) and
              packed: 32 utterances of 6 syllables (train.toydata's
              defaults) and 8 of 24 syllables, longer than the 480-frame
              batch; the first PackedDataset batch equal to the NpyDataset
              batch of seed 0, each reader's batch time; the trainer CLI
              (train.__main__.main) at full width, B=8, --durations mas
              --log-images: --packed for 4 steps and --data-dir for 1
              (losses finite and equal on the first step, MAS twice per
              step and the plain version never, steps_per_epoch 32 // 8,
              the JSONL and images written; ms per step, peak memory);
              the kernel against the plain version on a corpus step's
              ragged neg_cent and on a long-corpus batch; then serve.app's
              construction with --variant v1 (the full-width T5 as the
              shell's lyric_fn, MelodyConfig() and three SVSConfig()
              singers behind the fallback; no ollama on PATH) and with
              MUSIC_BACKEND=new and a stub $DIFFRHYTHM_REPO: over HTTP a
              keyword request and a raw_lyrics request through the shell,
              a request whose shell run raises answered by the model path
              (cold and warm, the warm one profiled), and the stub
              DiffRhythm's WAV returned
 15. seq train  the eight train.seq families (melody_note,
              melody_note_prev, seq2seq, telemelody, duration_mse,
              duration_sdp, gpt2, t5) at their default configs, B=16, toy
              data: parameter count; the first loss on the card against a
              CPU twin (dropout 0, same weights and batch, the SDP's
              posterior noise injected; t5's twin at 2 of its 12 layers);
              seven steps with dropout on through make_seq_train_step
              (warm ms, peak memory, launches of a profiled step), then
              more, untimed, until the loss is below the first (at most
              40); then the trainer CLI with --bf16 --durations mas at
              full width, B=8, four steps: every loss term of its first
              step within 20 % of a float32 step on the same weights,
              batch and draws, the masters float32 and moved, MAS twice
              per step, the kernel bit for bit against the plain version
              on a bf16 step's neg_cent, ms and peak memory beside phase
              8's float32 step; then melody_note and duration_mse trained
              three steps (train_family, checkpoints), exported by
              tools/torch_export_trained_melody.py and loaded by
              load_pipeline into the served melody generator: every tensor
              and the served notes and durations of a text equal to the
              trained modules
 16. parallel   the trainer CLI at full width (B=8, --durations mas, 4
              steps) as a one-rank NCCL group (--multihost --coordinator
              localhost:<port> --nprocs 1 --proc-id 0) in a subprocess
              (this script with --train-rank: the CLI watched from
              inside), against the one-device CLI here on the same
              batches, draws and weights, both with torch's deterministic
              algorithms: every loss term of every step bit-equal (else
              within 1e-4, with a second one-device run for the card's own
              floor), MAS twice per step and the kernel bit for bit on the
              first step's neg_cent, the c10d collectives of a profiled
              step, ms per step beside phase 8's; serve.app's songs with
              --mesh 1x1 over HTTP answering the WAV bytes of the songs
              without it, and --mesh 2x1 refused naming the device count;
              then the five offline tools on phase 14's toy corpus and
              one-step checkpoint: copy-synthesis, the sung song, MAS
              against ground truth, the two-singer HTTP demo over the
              exported file and the e2e demo's served melody, each JSON
              read back
Launch counts are zeroed just before each main path and read just after
it: phase 2b (maximum_path at four shapes), phases 3-4 (the served slices), phase 5 (the variants, which align
nothing: no MAS launch, kernel or plain), phase 8 (training), each
decoder's training steps in phase 10, phase 11's training steps and its
served configurations, phase 12 (which aligns nothing), phase 13's
served paths (none) and its training step, phase 14's two corpus
training runs and its served v1 paths (none), phase 15's families
(none) and its --bf16 CLI run, and phase 16's one-rank trainer (in its
subprocess). The kernels line reports the launches of phase 2b and of
phases 8, 11, 13, 14, 15 and 16's training (its "shapes" holds phase 2b's
rows). The lyric LMs, TeleMelody and the
other train.seq families launch no hand-written kernel. All phases run in
full float32 (TF32 is off for matmuls and cuDNN convolutions), except
phase 11's --decoder-bf16 decoders and phase 15's --bf16 steps, which
compute from bfloat16 casts. The last stdout line is the result JSON;
it is printed only when every phase passed. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

SEED = 0
MAS_SHAPE = (8, 480, 64)          # B, Ty (frames), Tx (phones)
# also held bit for bit: one to 32 columns per lane, a column count that is
# not a multiple of a warp,
# and the frame cap with enough phones to need > 48 KB of shared memory
EDGE_SHAPES = ((4, 60, 20), (4, 50, 45), (3, 1984, 200), (2, 1100, 1000))
# phase 2b: maximum_path at shapes the warp variant refuses, through the
# entry point (the wide variant), and the training shape (the warp
# variant): decision bits past the warp variant's shared memory at 64
# phones; ragged, 256 phones, with an item of more phones than frames;
# Tx > 1024
MAS_LONG_SHAPES = ((2, 20000, 64), (4, 8000, 256), (1, 3000, 1500),
                   MAS_SHAPE)
# ... and the wide variant alone (launched directly, also where the warp
# variant would do) at every K, 1 to 8 warps, and two strips
WIDE_EDGE_SHAPES = ((4, 60, 20), (4, 50, 45), (3, 200, 100), (2, 150, 200),
                    (2, 120, 400), (2, 1100, 1000), (3, 1761, 1024),
                    (2, 300, 1025), (2, 200, 2100), (2, 8500, 8400))
# the dependent chain of one item, in SM cycles per link (derived, not
# measured): a row is a shuffle (~24), fmaxf and fadd (4 each) and a
# select; a backtrace step is a dependent shared-memory load (~30) and a
# shift, compare and select; the wide variant's per-row hand-over is a
# shared store, a barrier and a shared load
MAS_ROW_CYCLES, MAS_STEP_CYCLES, MAS_BARRIER_CYCLES = 45, 40, 60
SM_CLOCK_HZ = 1.98e9              # H100 SXM boost clock
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


def long_case(device, shape, seed=SEED):
    """MAS inputs for phase 2b: item 0 full, item 1 with more phones than
    frames when there are four items (no monotonic path: the same
    deterministic answer from both versions), the rest random lengths
    with t_y >= t_x."""
    import torch
    b, t_y, t_x = shape
    gen = torch.Generator(device).manual_seed(seed)
    neg_cent = torch.randn(shape, generator=gen, device=device) * 10.0
    rng = np.random.RandomState(seed)
    lengths = [(t_y, t_x)]
    if b == 4:
        lengths.append((t_x // 2, t_x))
    while len(lengths) < b:
        tx = int(rng.randint(2, t_x + 1))
        lengths.append((int(rng.randint(tx, t_y + 1)), tx))
    mask = torch.zeros(shape, device=device)
    for i, (ty, tx) in enumerate(lengths):
        mask[i, :ty, :tx] = 1.0
    return neg_cent, mask, lengths


def mas_chain_bound_ms(shape, lengths) -> tuple[float, str]:
    """Least time for phase 2b's call, from the function alone: the larger
    of the bytes (inputs read once, the path written once) at the memory
    rate and the dependent chain of the longest item of this data, its
    rows and its backtrace steps."""
    b, t_y, t_x = shape
    rows = max(ty for ty, _ in lengths)
    chain = rows * (MAS_ROW_CYCLES + MAS_STEP_CYCLES) / SM_CLOCK_HZ
    by_bytes = 3 * b * t_y * t_x * 4 / HBM_BYTES_PER_S
    return ((by_bytes * 1e3, "bytes") if by_bytes >= chain
            else (chain * 1e3, "chain"))


def mas_design_chain_ms(plan, lengths) -> float:
    """The chain of the design mas_plan picks, not of the function: the
    bound's rows times the strips, plus the per-row hand-over barrier
    where the block has several warps. Shown beside the bound, never as
    it."""
    rows = max(ty for ty, _ in lengths)
    row = MAS_ROW_CYCLES + (MAS_BARRIER_CYCLES if plan.warps > 1 else 0)
    return (rows * plan.strips * row + rows * MAS_STEP_CYCLES) \
        / SM_CLOCK_HZ * 1e3


def phase_mas_shapes(device) -> dict:
    """Phase 2b: maximum_path at MAS_LONG_SHAPES through the entry point,
    counts zeroed just before and read just after (one launch each, the
    variant mas_plan picks, never the plain version); each path bit for bit
    the plain version's and one token per valid frame; then the wide
    variant alone at WIDE_EDGE_SHAPES against the plain version. Times: the
    kernel's CUDA-event median over warm runs, the plain version's single
    run, the bound."""
    import torch
    from music_generation_tpu_torch.ops import (mas_plan, maximum_path,
                                                maximum_path_torch)
    from music_generation_tpu_torch.ops.monotonic_align import (launch,
                                                                wide_plan)
    t0 = time.time()
    cases = [long_case(device, shape, SEED + 5) if shape != MAS_SHAPE
             else mas_case(device) for shape in MAS_LONG_SHAPES]
    maximum_path.kernel_launches = maximum_path.wide_launches = 0
    maximum_path.plain_calls = 0
    paths = [maximum_path(nc, m) for nc, m, _ in cases]
    torch.cuda.synchronize()
    launches, wide = maximum_path.kernel_launches, maximum_path.wide_launches
    n_wide = sum(mas_plan(*s[1:]).variant == "wide" for s in MAS_LONG_SHAPES)
    if (launches, wide, maximum_path.plain_calls) != (
            len(MAS_LONG_SHAPES), n_wide, 0):
        raise AssertionError(f"phase 2b: {launches} launches ({wide} wide, "
                             f"{maximum_path.plain_calls} plain), expected "
                             f"{len(MAS_LONG_SHAPES)} ({n_wide} wide, 0)")
    rows = []
    for shape, (nc, m, lengths), got in zip(MAS_LONG_SHAPES, cases, paths):
        plan = mas_plan(*shape[1:])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = maximum_path_torch(nc, m)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if not torch.equal(got, want):
            bad = (got != want).any(-1).nonzero()[:4].tolist()
            raise AssertionError(f"maximum_path ({plan.variant}) disagrees "
                                 f"with the plain version at {list(shape)}"
                                 f": [item, row] {bad}")
        if not torch.equal(got.sum(-1), m[:, :, 0]):
            raise AssertionError(f"path at {list(shape)} is not one token "
                                 f"per valid frame")
        ms = cuda_ms(lambda: maximum_path(nc, m), reps=10)
        bound_ms, bound_by = mas_chain_bound_ms(shape, lengths)
        design_ms = mas_design_chain_ms(plan, lengths)
        rows.append({"shape": list(shape), "variant": plan.variant,
                     "k": plan.k, "warps": plan.warps, "strips": plan.strips,
                     "smem_bytes": plan.smem_bytes,
                     "scratch_bytes": shape[0] * plan.scratch_bytes,
                     "lengths": [list(x) for x in lengths[:4]],
                     "launches": 1, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "design_chain_ms": design_ms})
        log(f"phase 2b: maximum_path == plain at {list(shape)} "
            f"({plan.variant}, K={plan.k}, {plan.warps} warps, "
            f"{plan.strips} strips): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms (one run), bound {bound_ms:.4f} ms "
            f"({bound_by}); the design's chain {design_ms:.4f} ms")
        del want
    del cases, paths
    for shape in WIDE_EDGE_SHAPES:
        nc, m, _ = mas_case(device, shape, SEED + 3)
        got = torch.empty_like(nc)
        launch(nc, m, got, wide_plan(*shape[1:]))
        if not torch.equal(got, maximum_path_torch(nc, m)):
            raise AssertionError(f"the wide variant disagrees with the "
                                 f"plain version at {list(shape)}")
    log(f"phase 2b: the wide variant alone == plain at "
        f"{[list(s) for s in WIDE_EDGE_SHAPES]}; {time.time() - t0:.1f} s")
    return {"shapes": rows, "launches": launches,
            "wide_edge_shapes": [list(s) for s in WIDE_EDGE_SHAPES],
            "seconds": time.time() - t0}


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


@contextlib.contextmanager
def serving(service):
    """``service`` behind the port's HTTP server on a free local port, on a
    thread: yields the port, then shuts both down."""
    from music_generation_tpu_torch.serve.app import make_http_server
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


@contextlib.contextmanager
def http_service(songs, lyrics=None, canned_dir=None):
    """The port's HTTP service around ``songs`` on a free local port, on a
    thread: yields (service, port), then shuts it down."""
    from music_generation_tpu_torch.config import ServiceConfig
    from music_generation_tpu_torch.serve.app import MusicGenerationService
    service = MusicGenerationService(songs, lyrics,
                                     ServiceConfig(log_dir="logs"),
                                     canned_dir=canned_dir)
    with serving(service) as port:
        yield service, port


def profiled(fn) -> dict:
    """fn() under torch.profiler: its wall, the device's busy time and
    share, the kernel launches and the heaviest kernels. The device events
    are read from the profiler's raw results: key_averages() would first
    build the host event tree, which took most of a minute for one
    68k-launch request."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        profiled_s = time.time() - t0
    kernels = {}                          # name -> [count, ns on the device]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = kernels.setdefault(e.name(), [0, 0])
            row[0] += 1
            row[1] += e.duration_ns()
    if not kernels:
        raise AssertionError("the profiler recorded no device work")
    busy_s = sum(ns for _, ns in kernels.values()) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    return {"profiled_s": profiled_s, "device_busy_s": busy_s,
            "device_busy_share": busy_s / profiled_s,
            "kernel_launches": sum(n for n, _ in kernels.values()),
            "top_kernels": [{"name": name[:80], "count": n, "ms": ns / 1e6}
                            for name, (n, ns) in top]}


def profile_request(songs, text: str) -> dict:
    """Where one warm request's time goes: SongSynthesizer's stage timings
    (unprofiled), then the same request under torch.profiler."""
    timings = songs.synthesize_song(text).timings
    return {**timings, **profiled(lambda: songs.synthesize_song(text))}


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
    from music_generation_tpu_torch.serve import app
    t0 = time.time()
    # built by serve.app's own construction (the default variant)
    args, cfg = app.configure(["--device", str(device)])
    songs = app.build_songs(args, cfg, seed=SEED)
    log(f"serve phase: full-width pipeline built in {time.time() - t0:.1f} s")
    clock = StageClock(t5_gen)
    latencies = []
    with http_service(songs, clock) as (service, port):
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
    breakdown = profile_request(songs, REQUESTS[0]["text"])
    log("serve profile: " + json.dumps(breakdown, ensure_ascii=False))
    return songs, latencies, keyword_rows, breakdown


# a one-character fragment merges into the next sentence with its comma
# (get_melody's comma branch); a line over 6 characters takes the breath
# branch; svs_v5 rewrites both LYRIC_REPLACEMENTS phrases
VARIANT_TEXT = "啊，我要飞向远方去飞翔。换你的梦，小小的天有大大的梦想"
VARIANT_SEED = SEED + 3


class MelodyRecorder:
    """Records what a melody generator's ``method`` returned, per call, as
    (lyric, notes, durations) per sentence."""

    def __init__(self, generator, method: str):
        self.sentences = []
        inner = getattr(generator, method)

        def recorded(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.sentences += out if method == "generate_song" else [out]
            return out
        setattr(generator, method, recorded)


def check_variant_melody(tag: str, sentences, sdp: bool) -> None:
    """As many notes as durations per sentence; under SDP every duration
    but the trailing 0.6 s rest inside handle_durations' band."""
    from music_generation_tpu_torch.models.melody import handle_durations
    for lyric, notes, durations in sentences:
        if len(notes) != len(durations) or not notes:
            raise AssertionError(f"{tag}: {lyric}: {len(notes)} notes, "
                                 f"{len(durations)} durations")
        if sdp and handle_durations(durations[:-1]) != durations[:-1]:
            raise AssertionError(f"{tag}: {lyric}: durations {durations} "
                                 "outside handle_durations' band")


def same_weights(a, b) -> None:
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    if sa.keys() != sb.keys() or not all(
            torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa):
        raise AssertionError("card and CPU models hold different weights")


def sdp_on_card_and_cpu(gen, cpu_gen, sentences) -> float:
    """The SDP raw durations of the request's sentences on the card and
    on the CPU, same weights and the same injected flow noise."""
    import torch
    from music_generation_tpu_torch.models.melody.api import SRC_LEN
    same_weights(gen.duration_model, cpu_gen.duration_model)
    src = torch.from_numpy(np.concatenate(
        [cpu_gen._encode_src(s) for s in sentences]))
    noise = torch.from_numpy(np.random.RandomState(VARIANT_SEED).randn(
        len(sentences), SRC_LEN, 2).astype(np.float32))
    cpu = cpu_gen.note_durations(src, noise=noise)
    card = gen.note_durations(src.to(gen.device), noise=noise.to(gen.device))
    rel = rel_l2(card, cpu)
    log(f"variants phase: SDP raw durations {list(cpu.shape)} card vs CPU "
        f"relative L2 {rel:.3e} (same injected noise)")
    if not rel <= LOGIT_REL_LIMIT:
        raise AssertionError(f"SDP durations card vs CPU: rel {rel}")
    return rel


class BeamRecorder:
    """Within ``with``, records each seq2seq beam_decode's tokens and, per
    step, whether the step's top beam + 1 combined scores held two within
    NEAR_TIE of each other (the top-k choice or the final best beam could
    part there)."""

    def __enter__(self):
        from music_generation_tpu_torch.models.melody import (seq2seq,
                                                              seq2seq_api)
        self.decodes = []
        self._patched = [(seq2seq, "topk_lower_index",
                          seq2seq.topk_lower_index),
                         (seq2seq_api, "beam_decode",
                          seq2seq_api.beam_decode)]
        topk, decode = (p[2] for p in self._patched)

        def recorded_topk(x, k):
            top = x.topk(k + 1).values
            self.decodes[-1]["ties"].append(
                bool(((top[:-1] - top[1:]) < NEAR_TIE).any()))
            return topk(x, k)

        def recorded_decode(*args, **kwargs):
            self.decodes.append({"ties": []})
            seq, score = decode(*args, **kwargs)
            self.decodes[-1]["tokens"] = seq.tolist()
            return seq, score
        seq2seq.topk_lower_index = recorded_topk
        seq2seq_api.beam_decode = recorded_decode
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._patched:
            setattr(module, name, fn)


def seq2seq_on_card_and_cpu(gen, cpu_gen, sentences) -> dict:
    """The three seq2seq models' teacher-forced log-probs on the card and
    the CPU (same weights), then get_melody of each sentence, identical up
    to the CPU decode's first near tie."""
    import random

    import torch
    from music_generation_tpu_torch.models.melody.seq2seq import START_ID
    rels = {}
    for name, lang in (("lyric2note", gen.lyric_lang),
                       ("lyric2duration", gen.lyric_lang),
                       ("note2duration", gen.note_lang)):
        card_model, cpu_model = getattr(gen, name), getattr(cpu_gen, name)
        same_weights(card_model, cpu_model)
        rng = np.random.RandomState(VARIANT_SEED)
        src = torch.from_numpy(rng.randint(
            4, lang.n_items, (len(sentences), 16)))
        src[1:, 9:] = 0     # right-padded sources beside a full one
        tgt = torch.from_numpy(rng.randint(
            4, card_model.cfg.de_vocab, (len(sentences), 16)))
        tgt[:, 0] = START_ID
        with torch.no_grad():
            cpu = cpu_model(src, tgt)
            card = card_model(src.to(gen.device), tgt.to(gen.device))
        rels[name] = rel_l2(card, cpu)
    gen._rand = random.Random(VARIANT_SEED)
    cpu_gen._rand = random.Random(VARIANT_SEED)
    parted = None
    with BeamRecorder() as cpu_rec:
        cpu_out = [cpu_gen.get_melody(s) for s in sentences]
    with BeamRecorder() as card_rec:
        card_out = [gen.get_melody(s) for s in sentences]
    for i, (c, g) in enumerate(zip(cpu_rec.decodes, card_rec.decodes)):
        if c["tokens"] == g["tokens"]:
            continue
        first = next(p for p, (a, b) in
                     enumerate(zip(c["tokens"], g["tokens"])) if a != b)
        if not (any(c["ties"][: first + 1]) or c["ties"][-1]):
            raise AssertionError(f"seq2seq decode {i} parts at step {first} "
                                 "with no near tie on the CPU")
        parted = {"decode": i, "step": first}
        break
    if parted is None and card_out != cpu_out:
        raise AssertionError(f"get_melody card {card_out} != CPU {cpu_out}")
    log(f"variants phase: seq2seq teacher-forced log-probs card vs CPU "
        f"relative L2 {json.dumps(rels)}; get_melody of "
        f"{len(sentences)} sentences ({len(cpu_rec.decodes)} beam decodes) "
        f"identical" + ("" if parted is None else
                        f" up to the CPU's near tie at {parted}"))
    if not all(r <= LOGIT_REL_LIMIT for r in rels.values()):
        raise AssertionError(f"seq2seq card vs CPU: {rels}")
    return {"logprobs_rel_l2": rels, "parted_at_near_tie": parted}


def serve_variant(name: str, songs, recorder, canned_dir=None) -> dict:
    """One cold and two warm VARIANT_TEXT requests through the port's HTTP
    service, each checked; then one warm request's stage timings and
    launches."""
    row = {"variant": name, "chars": len(VARIANT_TEXT)}
    with http_service(songs, canned_dir=canned_dir) as (_, port):
        for kind in ("cold", "warm", "warm_2"):
            recorder.sentences.clear()
            t0 = time.time()
            out = _post(port, {"text": VARIANT_TEXT})
            row[f"{kind}_s"] = time.time() - t0
            row["audio_s"] = check_song(f"{name} request", out)
            check_variant_melody(name, recorder.sentences,
                                 sdp=name.startswith("svs_v5"))
    row["sentences"] = [s[0] for s in recorder.sentences]
    row["profile"] = profile_request(songs, VARIANT_TEXT)
    log(f"variants phase: {name}: " + json.dumps(row, ensure_ascii=False))
    return row


def phase_variants(device, synthesizers) -> dict:
    """serve.app --variant svs_v5_multispeaker and --variant melody_v2 at
    full width (MelodyConfig() with SDPDurationConfig(); three
    Seq2SeqConfig() models), around the serve phase's three SVS
    synthesizers, each held against a CPU twin of its weights."""
    from music_generation_tpu_torch.pipeline.synthesis import (
        LYRIC_REPLACEMENTS, split_sentences)
    from music_generation_tpu_torch.serve.variants import (
        VARIANTS, build_melody_generator, variant_song_synthesizer)
    rows = {}
    for name in ("svs_v5_multispeaker", "melody_v2"):
        spec = VARIANTS[name]
        t0 = time.time()
        # built as serve.app's main() builds the variant
        songs = variant_song_synthesizer(spec, synthesizers, seed=SEED,
                                         device=device)
        melody = songs.melody
        cpu_melody = build_melody_generator(spec, seed=SEED, device="cpu")
        log(f"variants phase: {name} melody generator built on the card and "
            f"the CPU in {time.time() - t0:.1f} s")
        sentences = split_sentences(VARIANT_TEXT,
                                    replacements=songs.lyric_replacements)
        if spec.melody == "sdp":
            if not any(new in s for s in sentences
                       for _, new in LYRIC_REPLACEMENTS):
                raise AssertionError(f"no replacement in {sentences}")
            compared = {"sdp_rel_l2": sdp_on_card_and_cpu(
                melody, cpu_melody, sentences)}
            recorder = MelodyRecorder(melody, "generate_song")
        else:
            compared = seq2seq_on_card_and_cpu(melody.gen, cpu_melody.gen,
                                               sentences)
            recorder = MelodyRecorder(melody, "generate")
        del cpu_melody
        rows[name] = serve_variant(name, songs, recorder,
                                   canned_dir=spec.canned_dir) | compared
    return rows


def phase_gpu_vs_cpu(device):
    from music_generation_tpu_torch.models.svs import SVSConfig
    rel = visinger_card_vs_cpu(device, SVSConfig())
    log(f"gpu-vs-cpu phase: full-width VISinger.infer, relative L2 error "
        f"{rel:.3e} (TF32 off)")
    return rel


def visinger_card_vs_cpu(device, cfg) -> float:
    """One sentence through VISinger(cfg).infer on the CPU and on the
    card, same weights, noise and pinned durations: the relative L2 error
    of the card's waveform (fails above 1e-4)."""
    import torch
    from music_generation_tpu_torch.frontend import ScoreFrontend
    from music_generation_tpu_torch.models.svs import VISinger
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
    if not np.isfinite(gpu).all() or not rel <= 1e-4:
        raise AssertionError(f"{cfg.decoder_type} GPU vs CPU relative "
                             f"error {rel} over {len(cpu)} samples")
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
    # the random-init decoder, which the checkpoint phase's served weights
    # must differ from
    init_decoder = {k[len("gen."):]: v.cpu() for k, v in before.items()
                    if k.startswith("gen.decoder.")}
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
    del batches, live
    torch.cuda.empty_cache()
    result["gpu_vs_cpu"] = train_step_on_card_and_cpu(device)
    return result, (gen_state, disc_state, init_decoder)


def phases_before_train(device) -> dict:
    """Phases 2-7: the kernel's record, then the served slices (their MAS
    launches counted), the server variants, the card against the CPU and
    the lyric LMs."""
    import torch
    from music_generation_tpu_torch.ops import maximum_path
    record = phase_kernel(device)
    record["shapes"] = phase_mas_shapes(device)
    torch.cuda.empty_cache()

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
    songs, latencies, keyword_rows, breakdown = phase_serve(device, t5_gen,
                                                            gpt2_gen)
    if maximum_path.kernel_launches < 1 or maximum_path.plain_calls:
        raise AssertionError(f"main path launched the MAS kernel "
                             f"{maximum_path.kernel_launches} times (plain "
                             f"calls {maximum_path.plain_calls})")

    # serving aligns nothing: the variants' path runs no hand-written
    # kernel, and neither MAS version
    maximum_path.kernel_launches = 0
    variants = phase_variants(device, songs.synthesizers)
    if maximum_path.kernel_launches or maximum_path.plain_calls:
        raise AssertionError(f"the variants ran MAS: kernel "
                             f"{maximum_path.kernel_launches}, plain "
                             f"{maximum_path.plain_calls}")
    # the serve phase's pipeline, saved and kept on the host for the
    # checkpoint phase's round trip
    served = pipeline_snapshot(songs)
    del songs
    torch.cuda.empty_cache()

    rel = phase_gpu_vs_cpu(device)
    lyrics = phase_lyrics(device, t5_gen, gpt2_gen)
    del t5_gen, gpt2_gen
    torch.cuda.empty_cache()
    return {"record": record, "serve_latency_s": latencies,
            "serve_keyword": keyword_rows, "serve_profile": breakdown,
            "variants": variants,
            "gpu_vs_cpu_rel": rel, "lyrics": lyrics, "served": served}


SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
KEPT = SCRATCH / "kept"   # phase 14's corpus and step file, for phase 16
DECODER_TEXT = "小小的天有大大的梦想，我知道我一直有双隐形的翅膀"
DECODER_STEPS = 3         # full-width training steps per iSTFT decoder


def state_on_host(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def pipeline_models(songs) -> dict:
    """name -> model of every component compat.checkpoints saves."""
    out = {f"svs_{sid}": s.model for sid, s in songs.synthesizers.items()}
    out["melody_notes"] = songs.melody.note_model
    out["melody_duration"] = songs.melody.duration_model
    return out


def pipeline_snapshot(songs) -> dict:
    """save_pipeline(songs) into SCRATCH/pipeline, and a host copy of
    every saved model's state."""
    from music_generation_tpu_torch.compat import save_pipeline
    path = SCRATCH / "pipeline"
    save_pipeline(str(path), songs)
    return {"dir": str(path), "states": {
        k: state_on_host(m) for k, m in pipeline_models(songs).items()}}


def states_equal(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def serve_once(songs, text: str, kinds=("cold",)) -> dict:
    """``text`` through the port's HTTP service once per kind, each answer
    checked: seconds per kind and of audio."""
    row = {"chars": len(text)}
    with http_service(songs) as (_, port):
        for kind in kinds:
            t0 = time.time()
            out = _post(port, {"text": text})
            row[f"{kind}_s"] = time.time() - t0
            row["audio_s"] = check_song(f"{kind} request", out)
    return row


def phase_checkpoint(device, gen_state, disc_state, init_decoder,
                     served) -> dict:
    """Trained weights into the server at full width: the train phase's
    states through save_checkpoint and tools/torch_export_trained_svs.py
    to svs_0..2, served by serve.app's construction with --checkpoint-dir;
    then the serve phase's pipeline loaded into songs from another seed."""
    import shutil
    import torch
    from music_generation_tpu_torch.compat import load_pipeline
    from music_generation_tpu_torch.serve import app
    from music_generation_tpu_torch.train import save_checkpoint
    from music_generation_tpu_torch.ops import maximum_path
    from tools.torch_export_trained_svs import export_svs
    start = time.time()
    # the checkpoint path aligns nothing: no MAS launch, kernel or plain
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    row = {}
    try:
        trained = state_on_host(gen_state.model)
        t0 = time.time()
        ckpt = save_checkpoint(str(SCRATCH / "train"), gen_state,
                               disc_state, gen_state.step)
        row["save_checkpoint_s"] = time.time() - t0
        row["checkpoint_file"] = os.path.basename(ckpt)
        t0 = time.time()
        export_svs(ckpt, str(SCRATCH / "served"), speakers=(0, 1, 2))
        row["export_s"] = time.time() - t0
        args, cfg = app.configure(["--checkpoint-dir",
                                   str(SCRATCH / "served"), "--device",
                                   str(device)])
        t0 = time.time()
        songs = app.build_songs(args, cfg)
        torch.cuda.synchronize()
        row["build_and_load_s"] = time.time() - t0
        t0 = time.time()
        load_pipeline(cfg.checkpoint_dir, songs)
        torch.cuda.synchronize()
        row["load_s"] = time.time() - t0
        for sid, svs in songs.synthesizers.items():
            if not states_equal(state_on_host(svs.model), trained):
                raise AssertionError(f"served singer {sid} is not the "
                                     "trained generator")
        same = [k for k, v in init_decoder.items()
                if torch.equal(trained[k], v)]
        if same:
            raise AssertionError(f"trained decoder tensors still at their "
                                 f"init: {same[:4]}")
        row["served"] = serve_once(songs, REQUESTS[1]["text"])
        del songs
        torch.cuda.empty_cache()

        args, cfg = app.configure(["--device", str(device)])
        t0 = time.time()
        songs = app.build_songs(args, cfg, seed=SEED + 9)
        loaded = load_pipeline(served["dir"], songs)
        torch.cuda.synchronize()
        row["round_trip_build_and_load_s"] = time.time() - t0
        models = pipeline_models(songs)
        if sorted(f"{k}.pt" for k in models) != sorted(loaded):
            raise AssertionError(f"round trip loaded {loaded}")
        for name, model in models.items():
            if not states_equal(state_on_host(model),
                                served["states"][name]):
                raise AssertionError(f"round trip: {name} differs from "
                                     "the serve phase's")
        row["round_trip_files"] = loaded
        del songs
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()
    if maximum_path.kernel_launches or maximum_path.plain_calls:
        raise AssertionError(f"the checkpoint path ran MAS: kernel "
                             f"{maximum_path.kernel_launches}, plain "
                             f"{maximum_path.plain_calls}")
    row["phase_s"] = time.time() - start
    log(f"checkpoint phase ({row['phase_s']:.1f} s): trained generator -> "
        f"{row['checkpoint_file']}"
        f" -> svs_0..2 -> served: every tensor equal to the trained generator, "
        f"decoder off its init; save {row['save_checkpoint_s']:.1f} s, "
        f"export {row['export_s']:.1f} s, build + load "
        f"{row['build_and_load_s']:.1f} s, load {row['load_s']:.3f} s; "
        f"request {json.dumps(row['served'])}; pipeline round trip "
        f"{len(row['round_trip_files'])} files equal "
        f"({row['round_trip_build_and_load_s']:.1f} s)")
    return row


def decoder_train_steps(device, cfg, hold_mas: bool = False,
                        steps: int = DECODER_STEPS):
    """``steps`` full-width GAN steps (B=8, 64 phones, 480 frames,
    --durations mas) with ``cfg``: losses finite, every submodule moved,
    the MAS kernel twice per step and the plain version never; ms per warm
    step (none for one step) and peak memory. With ``hold_mas`` the kernel
    is also held bit for bit against the plain version on the first step's
    neg_cent, and the trained (generator, discriminator) states are
    returned beside the row."""
    import torch
    from music_generation_tpu_torch.ops import (maximum_path,
                                                maximum_path_torch,
                                                monotonic_align)
    from music_generation_tpu_torch.train import (TrainConfig, create_states,
                                                  make_train_step,
                                                  synthetic_batch, to_device,
                                                  tool_shapes)
    tc = TrainConfig(use_mas=True, warmup_steps=0)
    phones, frames = tool_shapes(False)
    gen_state, disc_state = create_states(cfg, tc, device)
    step = make_train_step(cfg, tc)
    generator = torch.Generator(device).manual_seed(SEED)
    before = {f"{tag}.{n}": p.detach().clone()
              for tag, s in (("gen", gen_state), ("disc", disc_state))
              for n, p in s.model.named_parameters()}
    live = []
    neg_cent_fn = monotonic_align.mas_neg_cent

    def capture(*args, **kwargs):
        out = neg_cent_fn(*args, **kwargs)
        if not live:
            live.append(tuple(x.clone() for x in out))
        return out

    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(steps):
        batch = to_device(synthetic_batch(cfg, batch=TRAIN_BATCH,
                                          t_phones=phones, t_frames=frames,
                                          seed=i), device)
        torch.cuda.synchronize()
        if hold_mas and i == 0:
            monotonic_align.mas_neg_cent = capture
        t0 = time.perf_counter()
        try:
            metrics = step(gen_state, disc_state, batch, generator)
            torch.cuda.synchronize()
        finally:
            monotonic_align.mas_neg_cent = neg_cent_fn
        ms.append((time.perf_counter() - t0) * 1e3)
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"{cfg.decoder_type} step {i}: {values}")
        losses.append({k: v for k, v in values.items()
                       if k.startswith("loss")})
    launches, plain = maximum_path.kernel_launches, maximum_path.plain_calls
    if launches != 2 * steps or plain:
        raise AssertionError(f"{cfg.decoder_type}: MAS kernel {launches} "
                             f"launches, plain {plain}")
    moved = {}
    for tag, s in (("gen", gen_state), ("disc", disc_state)):
        for n, p in s.model.named_parameters():
            key = f"{tag}.{n}"
            sub = ".".join(key.split(".")[:2])
            moved[sub] = moved.get(sub, 0) + (not torch.equal(before[key], p))
    still = sorted(k for k, v in moved.items() if not v)
    if still:
        raise AssertionError(f"{cfg.decoder_type}: no parameter of {still} "
                             "moved")
    row = {"cold_ms": ms[0], "warm_ms": ms[1:],
           "ms_per_warm_step": float(np.median(ms[1:])) if ms[1:] else None,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "mas_launches": launches, "mas_plain_calls": plain,
           "losses_first_last": [losses[0], losses[-1]]}
    if not hold_mas:
        return row
    # the kernel against the plain version on the step's own neg_cent
    # (these two calls come after the count was read)
    neg_cent, attn = live[0]
    if not torch.equal(maximum_path(neg_cent, attn),
                       maximum_path_torch(neg_cent, attn)):
        raise AssertionError("maximum_path kernel disagrees with the plain "
                             "version on a training step's neg_cent")
    row["live_neg_cent_shape"] = list(neg_cent.shape)
    return row, (gen_state, disc_state)


def phase_decoders(device) -> dict:
    """serve.app --decoder istft and mb_istft at full width: built by the
    server's construction, one text request cold and twice warm, a warm
    request's stage timings and launches; VISinger.infer on the card
    against the CPU; the decoder alone against the HiFi-GAN decoder on
    the same hidden state; DECODER_STEPS training steps."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    from music_generation_tpu_torch.serve import app
    from music_generation_tpu_torch.train import build_svs_config
    start = time.time()
    rows = {}
    hidden = torch.randn(4, 512, SVSConfig().inter_channels,
                         generator=torch.Generator(device).manual_seed(SEED),
                         device=device) * 0.5
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        hifigan = VISinger(SVSConfig()).decoder.to(device).eval()
    with torch.no_grad():
        hifigan_ms = cuda_ms(lambda: hifigan(hidden), reps=10)
    del hifigan
    for decoder in ("istft", "mb_istft"):
        t0 = time.time()
        args, cfg = app.configure(["--decoder", decoder, "--device",
                                   str(device)])
        songs = app.build_songs(args, cfg)
        row = {"build_s": time.time() - t0}
        row["served"] = serve_once(songs, DECODER_TEXT,
                                   kinds=("cold", "warm", "warm_2"))
        row["profile"] = profile_request(songs, DECODER_TEXT)
        model = songs.synthesizers[0].model
        with torch.no_grad():
            row["decoder_ms"] = cuda_ms(lambda: model.decoder(hidden),
                                        reps=10)
        row["hifigan_decoder_ms"] = hifigan_ms
        row["decoder_hidden_shape"] = list(hidden.shape)
        del songs, model
        torch.cuda.empty_cache()
        row["infer_card_vs_cpu_rel_l2"] = visinger_card_vs_cpu(
            device, SVSConfig(decoder_type=decoder))
        row["train"] = decoder_train_steps(
            device, build_svs_config(decoder=decoder))
        torch.cuda.empty_cache()
        rows[decoder] = row
        log(f"decoders phase: {decoder}: warm request "
            f"{row['served']['warm_s']:.3f} / {row['served']['warm_2_s']:.3f}"
            f" s (cold {row['served']['cold_s']:.3f} s), "
            f"{row['profile']['kernel_launches']} launches, busy "
            f"{row['profile']['device_busy_share']:.3f}; decoder "
            f"{row['decoder_ms']:.3f} ms vs HiFi-GAN {hifigan_ms:.3f} ms on "
            f"{list(hidden.shape)}; infer card vs CPU "
            f"{row['infer_card_vs_cpu_rel_l2']:.3e}; {DECODER_STEPS} "
            f"training steps: warm {row['train']['ms_per_warm_step']:.1f} "
            f"ms, peak {row['train']['peak_memory_bytes'] / 2 ** 30:.2f} "
            f"GiB, MAS {row['train']['mas_launches']} launches, plain 0")
    rows["phase_s"] = time.time() - start
    log(f"decoders phase: {rows['phase_s']:.1f} s")
    return rows


F0_FLAGS = {             # phase 11's served configurations
    "nsf_f0_residual": ["--nsf", "--f0-residual"],
    "nsf_f0_score": ["--nsf", "--f0", "score"],
    "decoder_bf16": ["--decoder-bf16"],
    "decoder_bf16_mb_istft": ["--decoder-bf16", "--decoder", "mb_istft"],
}
BF16_REL_MAE = 0.15       # bf16 decoder against float32: relative mean
                          # absolute error (tests/test_bf16_decoder.py)
F32_UNIT_ROUNDOFF = 2.0 ** -24


def served_scores(songs, text: str) -> list:
    """The scores singer 0's SVS call receives for ``text`` (one
    synthesize_song, recorded at dispatch_batch)."""
    svs = songs.synthesizers[0]
    seen = []
    dispatch = svs.dispatch_batch

    def record(scores, noise=None):
        seen.append(list(scores))
        return dispatch(scores, noise=noise)

    svs.dispatch_batch = record
    try:
        songs.synthesize_song(text)
    finally:
        del svs.dispatch_batch
    return [s for batch in seen for s in batch]


def phase_bound_cycles(n_samples: int, phase_max: float) -> float:
    """The most a float32 scan of non-negative terms can err, in cycles.
    A sum of non-negative terms whose every term passes through at most h
    roundings errs by at most h * u * S (Higham, Accuracy and Stability of
    Numerical Algorithms, 2nd ed., section 4.2), u = 2^-24 the unit
    roundoff and S the sum, here the phase's largest value. torch's CUDA
    cumsum along the last dim of a [B > 1, N] tensor scans 32-element
    chunks (5 tree levels) and carries the running total from chunk to
    chunk, h <= N / 32 + 5; of a [1, N] tensor it takes CUB's tiled scan,
    whose tiles hold more than 32 elements, h <= N / 32 + 42 with at most
    32 items per thread and 10 block levels. Each term f0 / sr adds at most
    3 roundings of its own (expm1, the product by the voiced mask, the
    division). So the bound is (ceil(N / 32) + 45) * u * S."""
    return (-(-n_samples // 32) + 45) * F32_UNIT_ROUNDOFF * phase_max


def nsf_card_vs_cpu(songs, text: str) -> dict:
    """The three-part card-vs-CPU check of an NSF server on the scores it
    serves for ``text`` (durations pinned to the card's prediction, the
    same prior noise): (a) infer_hidden, the decoder input, within 1e-4
    relative L2 of the CPU's; (b) the excitation's phase in cycles on the
    card against a float64 reference from the same log-F0, within
    phase_bound_cycles, beside the CPU float32's own error; (c)
    decode_hidden on the card fed the CPU's hidden state and excitation
    within 1e-4 of the CPU's decode. Also the voiced masks, card and CPU
    (frames that flip must lie within 1e-3 of the threshold), the voiced
    share (> 0.5) and the source's RMS (> 0)."""
    import torch
    from music_generation_tpu_torch.models.svs import VISinger
    from music_generation_tpu_torch.models.svs.excitation import (
        VOICED_LOG_F0_MIN, harmonic_phase)
    start = time.time()
    svs = songs.synthesizers[0]
    model, cfg = svs.model, svs.cfg
    scores = served_scores(songs, text)
    max_frames, packed = svs._batch_inputs(scores)
    args = (packed[0], packed[3, :, 0], packed[1],
            packed[4].view(torch.float32), packed[2])
    cpu_model = VISinger(cfg)
    cpu_model.load_state_dict(state_on_host(model))
    cpu_model.eval()
    noise = torch.from_numpy(np.random.RandomState(SEED + 11).randn(
        len(scores), max_frames, cfg.inter_channels).astype(np.float32))
    with torch.no_grad():
        frames = model.infer_hidden(*args, max_frames,
                                    generator=svs.generator)[2]["frames"]
        hid_g, len_g, aux_g = model.infer_hidden(
            *args, max_frames, ph_dur=frames, noise=noise.to(svs.device))
        hid_c, len_c, aux_c = cpu_model.infer_hidden(
            *(a.cpu() for a in args), max_frames, ph_dur=frames.cpu(),
            noise=noise)
        if not torch.equal(len_g.cpu(), len_c):
            raise AssertionError(f"mel_len {len_g} != {len_c}")
        row = {"batch": len(scores), "max_frames": max_frames,
               "mel_len": len_c.tolist(),
               "hidden_rel_l2": rel_l2(hid_g, hid_c)}
        # (b) the phase
        lf0 = aux_g["log_f0_used"]
        cycles_g, _ = harmonic_phase(lf0, cfg.hop_length, cfg.sampling_rate)
        lf0_c = lf0.cpu()
        f0 = torch.expm1(lf0_c.double().clamp(0.0, 9.0)) \
            * (lf0_c > VOICED_LOG_F0_MIN)
        ref = torch.cumsum(torch.repeat_interleave(f0, cfg.hop_length, 1)
                           / cfg.sampling_rate, dim=1)
        cycles_c, _ = harmonic_phase(lf0_c, cfg.hop_length,
                                     cfg.sampling_rate)
        bound = phase_bound_cycles(ref.shape[1], float(ref.max()))
        row |= {"phase_samples": ref.shape[1],
                "phase_max_cycles": float(ref.max()),
                "phase_err_cycles_card": float(
                    (cycles_g.cpu().double() - ref).abs().max()),
                "phase_err_cycles_cpu_f32": float(
                    (cycles_c.double() - ref).abs().max()),
                "phase_bound_cycles": bound}
        # the voiced masks, card and CPU
        valid = (torch.arange(max_frames)[None] < len_c[:, None])
        v_g = (lf0_c > VOICED_LOG_F0_MIN) & valid
        v_c = (aux_c["log_f0_used"] > VOICED_LOG_F0_MIN) & valid
        flips = v_g != v_c
        near = (aux_c["log_f0_used"] - VOICED_LOG_F0_MIN).abs() < 1e-3
        exc_g = aux_g["exc"][..., 0].cpu()
        samples = torch.repeat_interleave(valid, cfg.hop_length, 1)
        row |= {"voiced_flips": int(flips.sum()),
                "voiced_share": float(v_g.sum() / valid.sum()),
                "exc_rms": float(exc_g[samples].pow(2).mean().sqrt())}
        # (c) the decoder on the card, fed the CPU's inputs
        dec_c = cpu_model.decode_hidden(hid_c, aux_c["exc"])
        dec_g = model.decode_hidden(hid_c.to(svs.device),
                                    aux_c["exc"].to(svs.device))
        row["decode_rel_l2"] = rel_l2(dec_g, dec_c)
    del cpu_model
    row["seconds"] = time.time() - start
    bad = [k for k, lim in (("hidden_rel_l2", 1e-4), ("decode_rel_l2", 1e-4))
           if not row[k] <= lim]
    if bad or not row["phase_err_cycles_card"] <= bound:
        raise AssertionError(f"NSF card vs CPU: {bad} {row}")
    if (flips & ~near).any():
        raise AssertionError(f"voicing flips away from the threshold: {row}")
    if not row["voiced_share"] > 0.5 or not row["exc_rms"] > 0.0:
        raise AssertionError(f"silent NSF source: {row}")
    return row


def score_pitch_check(songs, text: str) -> dict:
    """Under --f0 score, the served log_f0_used is log1p of the score's
    note pitch, exactly: equal on voiced frames, 0 at rests and past the
    end."""
    import torch
    from music_generation_tpu_torch.core.masking import feature_mask
    from music_generation_tpu_torch.models.svs import note_hz_frames
    svs = songs.synthesizers[0]
    max_frames, packed = svs._batch_inputs(served_scores(songs, text))
    with torch.no_grad():
        _, mel_len, aux = svs.model.infer_hidden(
            packed[0], packed[3, :, 0], packed[1],
            packed[4].view(torch.float32), packed[2], max_frames,
            generator=svs.generator)
    hz = note_hz_frames(packed[1], aux["frames"], max_frames) \
        * feature_mask(mel_len, max_frames)[..., 0]
    used = aux["log_f0_used"]
    if not torch.equal(used, torch.log1p(hz)) or (used[hz == 0] != 0).any():
        raise AssertionError("--f0 score: log_f0_used is not the score's "
                             "pitch")
    valid = feature_mask(mel_len, max_frames)[..., 0] > 0
    return {"valid_frames": int(valid.sum()),
            "rest_frames": int(((hz == 0) & valid).sum())}


def decoders_alone(device) -> dict:
    """The HiFi-GAN decoder alone on hidden [4, 512, 192] (SVSConfig()
    weights from one seed): float32, decoder_bf16 and with the NSF source
    (its excitation computed apart); bf16 held to the relative-MAE bound
    of float32."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    gen = torch.Generator(device).manual_seed(SEED)
    hidden = torch.randn(4, 512, SVSConfig().inter_channels, generator=gen,
                         device=device) * 0.5
    log_f0 = torch.log1p(100.0 + 300.0 * torch.rand(
        4, 512, generator=gen, device=device))
    models = {}
    for name, cfg in (("f32", SVSConfig()),
                      ("bf16", SVSConfig(decoder_bf16=True)),
                      ("nsf", SVSConfig(nsf=True))):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            models[name] = VISinger(cfg).to(device).eval()
    row = {"hidden_shape": list(hidden.shape)}
    nsf = models["nsf"]
    with torch.no_grad():
        exc = nsf.excitation(log_f0)
        row["f32_ms"] = cuda_ms(lambda: models["f32"].decode_hidden(hidden),
                                reps=10)
        row["bf16_ms"] = cuda_ms(
            lambda: models["bf16"].decode_hidden(hidden), reps=10)
        row["nsf_ms"] = cuda_ms(lambda: nsf.decode_hidden(hidden, exc),
                                reps=10)
        row["excitation_ms"] = cuda_ms(lambda: nsf.excitation(log_f0),
                                       reps=10)
        f32 = models["f32"].decode_hidden(hidden)
        bf16 = models["bf16"].decode_hidden(hidden)
    if bf16.dtype != torch.float32 or not states_equal(
            state_on_host(models["f32"]), state_on_host(models["bf16"])):
        raise AssertionError("the bf16 decoder changed its output dtype or "
                             "its float32 parameters")
    row["bf16_rel_mae"] = float((bf16 - f32).abs().mean()
                                / f32.abs().mean())
    if not row["bf16_rel_mae"] < BF16_REL_MAE:
        raise AssertionError(f"bf16 decoder: {row}")
    return row


def phase_f0_variants(device) -> dict:
    """Phase 11: the SVS F0 and excitation variants at full width.
    Training with build_svs_config(nsf=True, f0_residual=True), MAS twice
    per step; that generator through save_checkpoint and the export tool
    into serve.app --checkpoint-dir --nsf --f0-residual (every tensor equal,
    exc convs included); the four served configurations of F0_FLAGS, each
    a text request cold and twice warm, a warm request's stage timings and
    launches, the NSF ones checked card against CPU; the score pitch; the
    decoder alone in float32, bf16 and with NSF."""
    import shutil
    import torch
    from music_generation_tpu_torch.core.masking import slice_segments
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.serve import app
    from music_generation_tpu_torch.train import (build_svs_config,
                                                  save_checkpoint)
    from tools.torch_export_trained_svs import export_svs
    start = time.time()
    rows = {}
    cfg = build_svs_config(nsf=True, f0_residual=True)
    t0 = time.time()
    train, (gen_state, disc_state) = decoder_train_steps(device, cfg,
                                                         hold_mas=True)
    train["phase_s"] = time.time() - t0
    # the excitation's own cost inside the step: the source at the batch's
    # full length, then its training slice
    log_f0 = torch.log1p(100.0 + 300.0 * torch.rand(
        TRAIN_BATCH, 480, generator=torch.Generator(device).manual_seed(
            SEED), device=device))
    ids = torch.zeros(TRAIN_BATCH, dtype=torch.int32, device=device)
    with torch.no_grad():
        train["excitation_ms"] = cuda_ms(lambda: slice_segments(
            gen_state.model.excitation(log_f0), ids * cfg.hop_length,
            cfg.segment_size), reps=10)
    rows["train"] = train
    log(f"f0 variants phase: {DECODER_STEPS} full-width steps with --nsf "
        f"--f0-residual (MAS): warm {train['ms_per_warm_step']:.1f} ms per "
        f"step, excitation {train['excitation_ms']:.4f} ms of it, peak "
        f"{train['peak_memory_bytes'] / 2 ** 30:.2f} GiB; MAS kernel "
        f"{train['mas_launches']} launches, plain 0, == plain on the step's "
        f"neg_cent")

    # serving aligns nothing: no MAS launch, kernel or plain
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    served_dir = SCRATCH / "f0" / "served"
    try:
        trained = state_on_host(gen_state.model)
        ckpt = save_checkpoint(str(SCRATCH / "f0" / "train"), gen_state,
                               disc_state, gen_state.step)
        del gen_state, disc_state
        torch.cuda.empty_cache()
        export_svs(ckpt, str(served_dir), speakers=(0, 1, 2), nsf=True,
                   f0_residual=True)
        for name, flags in F0_FLAGS.items():
            argv = flags + (["--checkpoint-dir", str(served_dir)]
                            if name == "nsf_f0_residual" else [])
            argv += ["--device", str(device)]
            t0 = time.time()
            args, scfg = app.configure(argv)
            songs = app.build_songs(args, scfg)
            torch.cuda.synchronize()
            row = {"flags": argv[:-2], "build_s": time.time() - t0}
            if name == "nsf_f0_residual":
                exc_keys = [k for k in trained if ".exc." in k]
                for sid, svs in songs.synthesizers.items():
                    if not states_equal(state_on_host(svs.model), trained):
                        raise AssertionError(f"served singer {sid} is not "
                                             "the trained generator")
                row["served_equal_tensors"] = len(trained)
                row["exc_tensors"] = len(exc_keys)
            row["served"] = serve_once(songs, DECODER_TEXT,
                                       kinds=("cold", "warm", "warm_2"))
            row["profile"] = profile_request(songs, DECODER_TEXT)
            if args.nsf:
                row["card_vs_cpu"] = nsf_card_vs_cpu(songs, DECODER_TEXT)
            if args.f0 == "score":
                row["score_pitch"] = score_pitch_check(songs, DECODER_TEXT)
            del songs
            torch.cuda.empty_cache()
            rows[name] = row
            log(f"f0 variants phase: {' '.join(row['flags'])}: warm "
                f"{row['served']['warm_s']:.3f} / "
                f"{row['served']['warm_2_s']:.3f} s (cold "
                f"{row['served']['cold_s']:.3f} s), melody "
                f"{row['profile']['melody_s']:.3f} s, svs "
                f"{row['profile']['svs_s']:.3f} s, "
                f"{row['profile']['kernel_launches']} launches, busy "
                f"{row['profile']['device_busy_share']:.3f}"
                + (f"; card vs CPU {json.dumps(row['card_vs_cpu'])}"
                   if "card_vs_cpu" in row else "")
                + (f"; score pitch {json.dumps(row['score_pitch'])}"
                   if "score_pitch" in row else ""))
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    if maximum_path.kernel_launches or maximum_path.plain_calls:
        raise AssertionError(f"the served variants ran MAS: kernel "
                             f"{maximum_path.kernel_launches}, plain "
                             f"{maximum_path.plain_calls}")
    rows["decoder_alone"] = decoders_alone(device)
    rows["phase_s"] = time.time() - start
    log(f"f0 variants phase ({rows['phase_s']:.1f} s): decoder alone "
        + json.dumps(rows["decoder_alone"]))
    return rows


SURFACE_TEXT = "小小的天有大大的梦想，我知道我一直有双隐形的翅膀，带我飞飞过绝望"
CHUNK_FRAMES, CHUNK_HALO = 64, 24     # the chunked batch decode checked
AUDIBLE_LSB = 1000                    # a stream's peak must reach this
CHUNK_REL = 1e-5                      # chunked decoder output against the
                                      # monolithic one, of its peak
MEMORY_BATCH = 16                     # sentences of the peak-memory batch


def sync_calls(fn) -> tuple[int, list]:
    """The synchronising CUDA calls fn() makes on this thread, counted by
    torch.cuda.set_sync_debug_mode("warn"): (count, their sources as
    "file:line x n", each the innermost frame of the port's package on the
    stack, else the frame that raised the warning and its source line)."""
    import collections
    import linecache
    import traceback
    import warnings
    import torch
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if "music_generation_tpu_torch" in f.filename]
        f = port[-1] if port else None
        where[f"{os.path.relpath(f.filename)}:{f.lineno}" if f
              else f"{os.path.relpath(filename)}:{lineno} "
              f"({linecache.getline(filename, lineno).strip()})"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(where.values()), [f"{k} x {n}" for k, n in
                                 where.most_common()]


def stream_http(port, payload) -> dict:
    """POST /synthesis_music_stream, its chunked body parsed chunk by
    chunk: the seconds to the header, to the first audio chunk (the first
    one after the header and the silent lead-in) and to the last chunk,
    the chunk count and the PCM."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.time()
    conn.request("POST", "/synthesis_music_stream",
                 body=json.dumps(payload, ensure_ascii=False).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if (resp.status != 200 or resp.getheader("Content-Type") != "audio/wav"
            or resp.getheader("Transfer-Encoding") != "chunked"):
        raise AssertionError(f"stream: {resp.status} {resp.getheaders()} "
                             f"{resp.read()[:200]}")
    chunks, times = [], []
    while True:
        size = int(resp.fp.readline().strip(), 16)
        if size == 0:
            resp.fp.readline()
            break
        chunks.append(resp.fp.read(size))
        resp.fp.read(2)
        times.append(time.time() - t0)
    conn.close()
    header, lead = chunks[0], np.frombuffer(chunks[1], np.int16)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE" or len(header) != 44:
        raise AssertionError(f"stream header {header!r}")
    if len(lead) != int(0.2 * 22050) or lead.any():
        raise AssertionError(f"stream lead-in: {len(lead)} samples")
    return {"header_s": times[0], "first_audio_s": times[2],
            "first_audio_after_header_s": times[2] - times[0],
            "last_chunk_s": times[-1], "chunks": len(chunks),
            "pcm": np.frombuffer(b"".join(chunks[1:]), np.int16)}


def stream_against_monolithic(svs, score) -> dict:
    """stream_score against clip(synthesize_score * STREAM_GAIN) to int16,
    the same injected prior noise: within 1 LSB, audible. The random-init
    conv_post is scaled by 32 (exact in float32, undone after) for it: its
    own output's peak is reported beside."""
    import torch
    max_frames = svs._batch_inputs([score])[0]
    noise = torch.randn((1, max_frames, svs.cfg.inter_channels),
                        generator=torch.Generator(svs.device).manual_seed(
                            SEED), device=svs.device)
    gain = svs.STREAM_GAIN
    row = {"frames_bucket": max_frames, "natural_peak_lsb": float(np.abs(
        svs.synthesize_score(score, noise=noise)).max() * gain)}
    weight = svs.model.decoder.conv_post.weight
    with torch.no_grad():
        weight.mul_(32.0)
    try:
        ref = svs.synthesize_score(score, noise=noise)
        chunks = list(svs.stream_score(score, noise=noise))
    finally:
        with torch.no_grad():
            weight.div_(32.0)
    want = np.clip(ref * gain, -32768, 32767).astype(np.int16)
    got = np.concatenate(chunks)
    row.update(chunks=len(chunks), samples=len(got),
               peak_lsb=int(np.abs(want.astype(np.int32)).max()))
    if len(got) != len(want) or len(chunks) < 2:
        raise AssertionError(f"stream vs monolithic: {row}")
    row["max_lsb_diff"] = int(np.abs(got.astype(np.int32) - want).max())
    if row["max_lsb_diff"] > 1 or row["peak_lsb"] < AUDIBLE_LSB:
        raise AssertionError(f"stream vs monolithic: {row}")
    return row


def chunked_against_monolithic(svs, scores) -> dict:
    """The int16 batch (dispatch_batch) with decode_chunk_frames=64, halo
    24, against the monolithic one, the same prior noise: within 1 LSB;
    the decoder's float output within CHUNK_REL of its peak."""
    import torch
    max_frames = svs._batch_inputs(scores)[0]
    noise = torch.randn((len(scores), max_frames, svs.cfg.inter_channels),
                        generator=torch.Generator(svs.device).manual_seed(
                            SEED + 1), device=svs.device)
    out = {}
    for chunk in (None, CHUNK_FRAMES):
        svs.decode_chunk_frames, svs.decode_chunk_halo = chunk, CHUNK_HALO
        out[chunk] = svs.collect_batch(svs.dispatch_batch(scores, noise))
    with torch.no_grad():
        hidden, _, aux = svs._infer_hidden(scores, noise)
        mono = svs.model.decode_hidden(hidden, aux.get("exc"))
        chunked = svs._chunked_decode(hidden, aux.get("exc"))
    svs.decode_chunk_frames = None
    peak = float(mono.abs().max())
    row = {"frames_bucket": max_frames, "sentences": len(scores),
           "windows": -(-max_frames // CHUNK_FRAMES),
           "max_lsb_diff": max(int(np.abs(a.astype(np.int32) - b).max())
                               for a, b in zip(out[None], out[CHUNK_FRAMES])),
           "float_max_abs_diff": float((chunked - mono).abs().max()),
           "float_peak": peak}
    if ([len(a) for a in out[None]] != [len(a) for a in out[CHUNK_FRAMES]]
            or row["max_lsb_diff"] > 1
            or row["float_max_abs_diff"] > CHUNK_REL * peak):
        raise AssertionError(f"chunked vs monolithic decode: {row}")
    return row


def batch_peak_memory(svs) -> dict:
    """torch.cuda.max_memory_allocated of one 16-sentence batch at the
    1984-frame bucket, monolithic and chunked (64 frames, halo 24), and
    the seconds of each (host clock to a synchronize)."""
    import torch
    from music_generation_tpu_torch.pipeline.synthesis import FRAME_BUCKETS
    text = BENCH_SENTENCES[0]
    score = svs.frontend.align(text + "AP", ["C4"] * (len(text) + 1),
                               [0.9] * (len(text) + 1))
    scores = [score] * MEMORY_BATCH
    row = {"frames_bucket": svs._batch_inputs(scores)[0]}
    if row["frames_bucket"] != FRAME_BUCKETS[-1]:
        raise AssertionError(f"memory batch bucket {row}")
    def peak(fn) -> tuple[float, int]:
        """(seconds, peak bytes allocated above what was live before)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0, torch.cuda.max_memory_allocated() - base

    for name, chunk in (("monolithic", None), ("chunked", CHUNK_FRAMES)):
        svs.decode_chunk_frames = chunk
        row[f"{name}_s"], row[f"{name}_peak_bytes"] = peak(
            lambda: svs.collect_batch(svs.dispatch_batch(scores)))
    svs.decode_chunk_frames = None
    # where the chunked peak comes from: infer_hidden alone, then one
    # window of 64 + 2 x 24 frames through the decoder
    with torch.no_grad():
        _, row["infer_hidden_peak_bytes"] = peak(
            lambda: svs._infer_hidden(scores))
        hidden = svs._infer_hidden(scores)[0][:, : CHUNK_FRAMES
                                              + 2 * CHUNK_HALO]
        _, row["window_decode_peak_bytes"] = peak(
            lambda: svs.model.decode_hidden(hidden))
    return row


def phase_served_surface(device) -> dict:
    """Phase 12: serve.app's build_service with --fused --warmup at full
    width; the fused path for a lone request (by the service's path
    counter), its notes and sentence lengths against the staged path,
    pinned durations, launches, busy share and the synchronising calls of
    each path; two concurrent requests through the staged path's batcher;
    POST /synthesis_music_stream; stream_score against the monolithic
    decode; the chunked batch decode against the monolithic one, plain and
    under --nsf --f0 score; the decoder's receptive field; peak memory of
    a 16-sentence 1984-frame batch. Runs no MAS, kernel or plain."""
    import torch
    from music_generation_tpu_torch.models.svs.hifigan import (
        receptive_radius_frames)
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.pipeline.synthesis import (
        build_svs_synthesizers)
    from music_generation_tpu_torch.serve import app
    start = time.time()
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    rows, steps = {}, {}                  # steps: seconds into the phase
    t0 = time.time()
    args, cfg = app.configure(["--fused", "--warmup", "--device",
                               str(device)])
    service = app.build_service(args, cfg)
    torch.cuda.synchronize()
    warm = service.warmup
    rows["build_s"] = (time.time() - t0 - warm["request_s"]
                       - warm["staged_s"])
    rows["warmup"] = warm
    if warm["code"] != 200 or service.fused is None:
        raise AssertionError(f"--fused --warmup: {warm}")
    songs, fused = service.songs, service.fused
    text = REQUESTS[0]["text"]
    with serving(service) as port:
        # a lone request, cold and twice warm: the fused path each time
        row = {"chars": len(text)}
        before = dict(service.path_counts)
        for kind in ("cold", "warm", "warm_2"):
            t1 = time.time()
            out = _post(port, {"text": text})
            row[f"{kind}_s"] = time.time() - t1
            row["audio_s"] = check_song(f"fused {kind} request", out)
        if service.path_counts != {"fused": before["fused"] + 3,
                                   "staged": before["staged"]}:
            raise AssertionError(f"lone requests did not take the fused "
                                 f"path: {before} -> {service.path_counts}")
        rows["fused_requests"] = row

        # two concurrent requests while a third holds the fused path: both
        # staged, through the batcher
        gate, held_out = threading.Event(), []
        fused_song = fused.synthesize_song

        def held(*a, **k):
            gate.wait(120)
            return fused_song(*a, **k)

        before = dict(service.path_counts)
        stats0 = dict(service._batcher.stats)
        fused.synthesize_song = held
        try:
            first = threading.Thread(target=lambda: held_out.append(
                _post(port, {"text": text})))
            first.start()
            deadline = time.time() + 120
            while service.path_counts["fused"] == before["fused"]:
                if time.time() > deadline:
                    raise AssertionError("the held request never started")
                time.sleep(0.005)
            pair = []
            threads = [threading.Thread(target=lambda p=p: pair.append(
                _post(port, p))) for p in REQUESTS[1:]]
            t1 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            pair_s = time.time() - t1
        finally:
            gate.set()
            del fused.synthesize_song
            first.join(timeout=300)
        for i, out in enumerate(pair + held_out):
            check_song(f"concurrent request {i}", out)
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=60).read())
        batching = {k: health["batching"][k] - stats0[k]
                    for k in ("requests", "device_calls", "sentences")}
        if (service.path_counts != {"fused": before["fused"] + 1,
                                    "staged": before["staged"] + 2}
                or batching["requests"] != 2 or not health.get("fused")):
            raise AssertionError(f"concurrent requests: {service.path_counts}"
                                 f" {health}")
        rows["concurrent"] = {"pair_s": pair_s, "batching": batching,
                              "healthz_fused": health["fused"]}

        # streaming over HTTP, cold (the first windows of their shapes)
        # and warm, against the staged song of the same text
        staged_samples = 4410 + sum(
            songs.synthesize_song(text).sentence_samples)
        for kind in ("cold", "warm"):
            stream = stream_http(port, {"text": text})
            stream["pcm_samples"] = len(stream.pop("pcm"))
            if stream["pcm_samples"] != staged_samples:
                raise AssertionError(f"stream length: {stream}, staged "
                                     f"{staged_samples}")
            rows[f"stream_http_{kind}"] = stream
        steps["requests_and_stream"] = time.time() - start

    # the fused path against the staged one on the same weights
    same = {}
    for t in (text, SURFACE_TEXT):
        a, b = fused.synthesize_song(t), songs.synthesize_song(t)
        if a.notes != b.notes or a.sentence_samples != b.sentence_samples:
            raise AssertionError(f"fused vs staged: {a.notes} {b.notes} "
                                 f"{a.sentence_samples} "
                                 f"{b.sentence_samples}")
        same[str(len(a.lyrics_sentences))] = a.sentence_samples
    steps["fused_notes_and_lengths"] = time.time() - start
    short = fused.synthesize_song(text, pinned_syllable_seconds=0.2)
    long = fused.synthesize_song(text, pinned_syllable_seconds=0.5)
    ratio = sum(long.sentence_samples) / sum(short.sentence_samples)
    if not ratio > 1.5:
        raise AssertionError(f"pinned 0.5 / 0.2 s samples: {ratio}")
    rows["fused_vs_staged"] = {"sentence_samples": same,
                               "pinned_ratio": ratio}
    steps["pinned"] = time.time() - start
    # warm walls in turns (before any profiler session, which slows what
    # follows it), then each path's launches, busy share and synchronising
    # calls
    paths = {"fused": fused, "staged": songs}
    walls = {"fused": [], "staged": []}
    for name in ("fused", "staged", "staged", "fused", "fused", "staged"):
        t1 = time.time()
        paths[name].synthesize_song(text)
        torch.cuda.synchronize()
        walls[name].append(time.time() - t1)
    steps["walls"] = time.time() - start
    for name, path in paths.items():
        r = {"warm_walls_s": walls[name]}
        r["sync_calls"], r["sync_sources"] = sync_calls(
            lambda: path.synthesize_song(text))
        steps[f"{name}_sync_calls"] = time.time() - start
        r.update(profiled(lambda: path.synthesize_song(text)))
        steps[f"{name}_profiled"] = time.time() - start
        rows[f"{name}_profile"] = r

    # streaming against the monolithic decode, one full-width sentence
    svs = songs.synthesizers[0]
    scores = songs._scores(svs, BENCH_SENTENCES)[1]
    rows["stream_vs_monolithic"] = stream_against_monolithic(svs, scores[0])
    # the chunked batch decode: plain, then under --nsf --f0 score
    c = svs.cfg
    reach = receptive_radius_frames(
        c.resblock, c.resblock_kernel_sizes, c.resblock_dilation_sizes,
        c.upsample_rates, c.upsample_kernel_sizes)
    if reach > CHUNK_HALO:
        raise AssertionError(f"halo {CHUNK_HALO} < receptive field {reach}")
    rows["receptive_field_frames"] = reach
    rows["chunked"] = chunked_against_monolithic(svs, scores)
    steps["stream_and_chunked"] = time.time() - start
    rows["memory"] = batch_peak_memory(svs)
    steps["memory"] = time.time() - start
    del service, songs, fused, svs, paths
    torch.cuda.empty_cache()
    nsf = build_svs_synthesizers(n_speakers=1, seed=SEED, device=device,
                                 nsf=True, f0_mode="score")[0]
    rows["chunked_nsf_score"] = chunked_against_monolithic(nsf, scores)
    del nsf
    torch.cuda.empty_cache()
    if maximum_path.kernel_launches or maximum_path.plain_calls:
        raise AssertionError(f"the served surface ran MAS: kernel "
                             f"{maximum_path.kernel_launches}, plain "
                             f"{maximum_path.plain_calls}")
    rows["phase_s"] = time.time() - start
    rows["steps_s"] = steps
    fp, sp = rows["fused_profile"], rows["staged_profile"]
    st = rows["stream_http_warm"]
    log(f"served surface phase ({rows['phase_s']:.1f} s): build "
        f"{rows['build_s']:.1f} s, --warmup {warm['request_s']:.2f} s fused "
        f"+ {warm['staged_s']:.2f} s staged; fused lone request cold "
        f"{rows['fused_requests']['cold_s']:.3f} s, warm "
        f"{rows['fused_requests']['warm_s']:.3f} / "
        f"{rows['fused_requests']['warm_2_s']:.3f} s; warm fused / staged: "
        f"{min(fp['warm_walls_s']):.3f} / {min(sp['warm_walls_s']):.3f} s "
        f"(best of 3 in turns), "
        f"{fp['kernel_launches']} / {sp['kernel_launches']} launches, busy "
        f"{fp['device_busy_share']:.3f} / {sp['device_busy_share']:.3f}, "
        f"sync calls {fp['sync_calls']} / {sp['sync_calls']}; warm stream: "
        f"first audio {st['first_audio_after_header_s']:.3f} s after the "
        f"header (cold "
        f"{rows['stream_http_cold']['first_audio_after_header_s']:.3f} s), "
        f"last chunk {st['last_chunk_s']:.3f} s, {st['chunks']} chunks; "
        f"stream vs monolithic "
        f"{rows['stream_vs_monolithic']['max_lsb_diff']} LSB (peak "
        f"{rows['stream_vs_monolithic']['peak_lsb']}); chunked vs monolithic "
        f"{rows['chunked']['max_lsb_diff']} / "
        f"{rows['chunked_nsf_score']['max_lsb_diff']} LSB (nsf); receptive "
        f"field {rows['receptive_field_frames']} frames <= halo "
        f"{CHUNK_HALO}; peak memory 16 x 1984 frames monolithic "
        f"{rows['memory']['monolithic_peak_bytes'] / 2 ** 30:.2f} GiB, "
        f"chunked {rows['memory']['chunked_peak_bytes'] / 2 ** 30:.2f} GiB; "
        f"MAS 0 launches, plain 0")
    log("served surface phase: " + json.dumps(rows, ensure_ascii=False))
    return rows


# ---- phase 13: v1_model and the SVS probes --------------------------------

V1_TEXT = REQUESTS[0]["text"]     # 4 sentences, 44 characters
SCORE_LINE = ("t|小小的天有大大的梦想|C4 D4 E4 F4 G4 A4 G4 F4 E4 D4|"
              "0.3 0.3 0.4 0.5 0.3 0.3 0.4 0.3 0.3 0.6")
PROBE_FRAMES = 512                # the probes' spectrogram: [2, 512, 513]
PROBE_GIN = 256                   # speaker conditioning width


class SharedDraws:
    """Within ``with``, every sample_decode of models/melody/telemelody.py
    takes its Gumbel draws from one CPU torch.Generator seeded with
    ``seed`` (moved to the decode's device), one call after another, so
    that the card and the CPU decode on the same draws. Records each
    call's tokens, draws and, with ``keep_logits``, each step's log-probs
    on the host (the CPU side, for its near ties)."""

    def __init__(self, seed: int, keep_logits: bool = False):
        self.seed, self.keep_logits = seed, keep_logits

    def __enter__(self):
        import torch
        from music_generation_tpu_torch.models.melody import beam, telemelody
        self._orig = telemelody.sample_decode
        gen = torch.Generator().manual_seed(self.seed)
        self.calls = []

        def drawn(decode_logits, max_len, *args, top_k=10, **kwargs):
            call = {"noise": beam.gumbel((max_len, top_k), gen),
                    "top_k": top_k, "logits": []}
            self.calls.append(call)

            def logits(tokens, step):
                out = decode_logits(tokens, step)
                if self.keep_logits:
                    call["logits"].append(out[0].detach().cpu())
                return out
            tokens = self._orig(logits, max_len, *args, top_k=top_k,
                                noise=call["noise"], **kwargs)
            call["tokens"] = tokens.tolist()
            call["min_len"] = kwargs["min_len"]
            call["temperature"] = kwargs["temperature"]
            return tokens
        telemelody.sample_decode = drawn
        return self

    def __exit__(self, *exc):
        from music_generation_tpu_torch.models.melody import telemelody
        telemelody.sample_decode = self._orig


def sample_near_tie(call, step: int) -> bool:
    """Whether the CPU's sampled step could part from the card's: its top
    k boundary (log-probs over temperature, EOS barred before min_len) or
    its Gumbel-max pick within NEAR_TIE."""
    import torch
    from music_generation_tpu_torch.models.melody.beam import (
        NEG_INF, topk_lower_index)
    from music_generation_tpu_torch.models.melody.vocab import EOS_ID
    lp = call["logits"][step] / call["temperature"]
    if step < call["min_len"]:
        lp = torch.where(torch.arange(lp.shape[-1]) == EOS_ID, NEG_INF, lp)
    vals, _ = topk_lower_index(lp, call["top_k"] + 1)
    picks = (vals[:-1] + call["noise"][step]).sort(descending=True).values
    return bool(vals[-2] - vals[-1] < NEAR_TIE
                or picks[0] - picks[1] < NEAR_TIE)


def telemelody_on_card_and_cpu(gen, sentences) -> dict:
    """The full-width TeleMelody twins on the card against a CPU copy of
    the same weights: teacher-forced log-probs of both twins; get_melody
    of every sentence on the same Gumbel draws (SharedDraws), tokens equal
    up to the CPU's first near tie, notes and durations equal."""
    import torch
    from music_generation_tpu_torch.models.melody import (MelodyConfig,
                                                          TeleMelodyGenerator)
    from music_generation_tpu_torch.models.melody.transformer import (
        causal_mask)
    t0 = time.time()
    cpu = TeleMelodyGenerator(MelodyConfig(), seed=SEED, device="cpu")
    row = {"cpu_build_s": time.time() - t0, "logprobs_rel_l2": {}}
    for name in ("lyric2rhythm", "trend2melody"):
        card_model, cpu_model = getattr(gen, name), getattr(cpu, name)
        same_weights(card_model, cpu_model)
        rng = np.random.RandomState(VARIANT_SEED)
        src = torch.from_numpy(rng.randint(4, card_model.cfg.src_vocab,
                                           (2, 24)))
        src[1, 15:] = 0
        tgt = torch.from_numpy(rng.randint(4, card_model.cfg.tgt_vocab,
                                           (2, 40)))
        src_mask = (src != 0)[:, None, None, :].to(torch.int32)
        with torch.no_grad():
            want = cpu_model(src, tgt, src_mask, causal_mask(40))
            got = card_model(src.to(gen.device), tgt.to(gen.device),
                             src_mask.to(gen.device),
                             causal_mask(40, device=gen.device))
        row["logprobs_rel_l2"][name] = rel_l2(got, want)
    if not all(r <= LOGIT_REL_LIMIT for r in row["logprobs_rel_l2"].values()):
        raise AssertionError(f"TeleMelody card vs CPU: {row}")
    t0 = time.time()
    with SharedDraws(VARIANT_SEED, keep_logits=True) as cpu_draws:
        cpu_out = [cpu.get_melody(s)[1:] for s in sentences]
    row["cpu_get_melody_s"] = time.time() - t0
    t0 = time.time()
    with SharedDraws(VARIANT_SEED) as card_draws:
        card_out = [gen.get_melody(s)[1:] for s in sentences]
    torch.cuda.synchronize()
    row["card_get_melody_s"] = time.time() - t0
    parted = None
    for i, (c, g) in enumerate(zip(cpu_draws.calls, card_draws.calls)):
        if c["tokens"] == g["tokens"]:
            continue
        first = next(p for p, (a, b) in
                     enumerate(zip(c["tokens"], g["tokens"])) if a != b)
        if not any(sample_near_tie(c, s) for s in range(first + 1)):
            raise AssertionError(f"TeleMelody decode {i} parts at step "
                                 f"{first} with no near tie on the CPU")
        parted = {"decode": i, "step": first}
        break
    if parted is None and card_out != cpu_out:
        raise AssertionError(f"get_melody card {card_out} != CPU {cpu_out}")
    row.update(decodes=len(cpu_draws.calls),
               decode_steps=[len(c["tokens"]) for c in cpu_draws.calls],
               parted_at_near_tie=parted,
               notes_per_sentence=[len(p) for _, p in cpu_out])
    log(f"v1_model phase: TeleMelody log-probs card vs CPU "
        f"{json.dumps(row['logprobs_rel_l2'])}; get_melody of "
        f"{len(sentences)} sentences ({row['decodes']} sampled decodes on "
        f"shared draws) identical" + ("" if parted is None else
                                      f" up to the CPU's near tie {parted}"))
    return row


def v1_accompaniment(songs) -> dict:
    """The same request with and without the accompaniment (the melody's
    and the singer's draws restored between them): the same notes and
    length, other samples."""
    from scipy.io import wavfile
    svs = songs.synthesizers[0]
    states = (songs.melody.gen.generator.get_state(),
              svs.generator.get_state())
    mixed = songs.synthesize_song(V1_TEXT)
    songs.melody.gen.generator.set_state(states[0])
    svs.generator.set_state(states[1])
    songs.mix_accompaniment = False
    try:
        vocal = songs.synthesize_song(V1_TEXT)
    finally:
        songs.mix_accompaniment = True
    _, a = wavfile.read(io.BytesIO(mixed.wav_bytes))
    _, v = wavfile.read(io.BytesIO(vocal.wav_bytes))
    if mixed.notes != vocal.notes or len(a) != len(v):
        raise AssertionError(f"mixed song: {len(a)} samples, notes "
                             f"{mixed.notes}; vocal {len(v)}, {vocal.notes}")
    if np.array_equal(a, v):
        raise AssertionError("the mixed song equals the vocal alone")
    return {"samples": len(a), "accompaniment_s":
            mixed.timings["accompaniment_s"],
            "samples_changed_share": float(np.mean(a != v)),
            "mixed_timings": mixed.timings, "vocal_timings": vocal.timings}


def score_cli(device) -> dict:
    """python -m music_generation_tpu_torch.pipeline out.wav --score LINE at
    full width: an int16 22,050 Hz WAV at least the score's length."""
    from scipy.io import wavfile
    from music_generation_tpu_torch.pipeline.__main__ import main as cli
    out = SCRATCH / "score.wav"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cli([str(out), "--score", SCORE_LINE, "--device", str(device)])
    seconds = time.time() - t0
    rate, pcm = wavfile.read(out)
    want = sum(float(x) for x in SCORE_LINE.split("|")[3].split())
    if rate != 22050 or pcm.dtype != np.int16 or len(pcm) < 0.5 * want * rate:
        raise AssertionError(f"--score: rate {rate}, {pcm.dtype}, "
                             f"{len(pcm)} samples for {want} s")
    if not np.any(pcm != 0):
        raise AssertionError("--score wrote silence")
    return {"cli_s": seconds, "audio_s": len(pcm) / rate,
            "score_s": want, "peak": int(np.abs(pcm.astype(np.int32)).max())}


def excite_zero_parameters(model, seed: int) -> None:
    """Give every parameter that starts at exactly zero (the flows' output
    projections, biases) small random values, so that a random-init flow is
    not the identity and the speaker conditioning acts."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def svs_probes_card_vs_cpu(device) -> dict:
    """infer_fake (cut to 384 frames), copy_synthesis and voice_conversion
    (g_src != g_tgt) of a full-width SVSConfig(gin_channels=256) on [2,
    512, 513] spectrograms: card against CPU, same weights and posterior
    noise, within 1e-4 relative L2; on the card, voice_conversion with
    g_tgt == g_src gives z back within 1e-4."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    cfg = SVSConfig(gin_channels=PROBE_GIN)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 4)
        cpu_model = VISinger(cfg).eval()
    excite_zero_parameters(cpu_model, SEED + 4)
    card_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.RandomState(SEED + 4)
    b, f = 2, PROBE_FRAMES
    x = {"spec": np.abs(rng.randn(b, f, cfg.spec_channels)),
         "y_lengths": np.array([f, f - 105]),
         "noise": rng.randn(b, f, cfg.inter_channels),
         "g_src": rng.randn(b, 1, PROBE_GIN),
         "g_tgt": rng.randn(b, 1, PROBE_GIN)}
    x = {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                      else np.int64)) for k, v in x.items()}
    probes = {
        "infer_fake": lambda m, a: m.infer_fake(
            a["spec"], a["y_lengths"], max_len=384, noise=a["noise"]),
        "copy_synthesis": lambda m, a: m.copy_synthesis(
            a["spec"], a["y_lengths"], noise=a["noise"]),
        "voice_conversion": lambda m, a: m.voice_conversion(
            a["spec"], a["y_lengths"], a["g_src"], a["g_tgt"],
            noise=a["noise"]),
    }
    row = {"shape": [b, f, cfg.spec_channels], "gin_channels": PROBE_GIN}
    on_card = {k: v.to(device) for k, v in x.items()}
    card_out = {}
    for name, probe in probes.items():
        with torch.no_grad():
            t0 = time.time()
            want = probe(cpu_model, x)
            cpu_s = time.time() - t0
            probe(card_model, on_card)                  # warm
            torch.cuda.synchronize()
            t0 = time.time()
            got = card_out[name] = probe(card_model, on_card)
            torch.cuda.synchronize()
        z_got, z_want = ((got[2][2], want[2][2]) if name ==
                         "voice_conversion" else (got[2], want[2]))
        row[name] = {"audio_rel_l2": rel_l2(got[0], want[0]),
                     "z_rel_l2": rel_l2(z_got, z_want),
                     "card_s": time.time() - t0, "cpu_s": cpu_s,
                     "samples": int(got[0].shape[1])}
        if not (torch.isfinite(got[0]).all()
                and row[name]["audio_rel_l2"] <= LOGIT_REL_LIMIT
                and row[name]["z_rel_l2"] <= LOGIT_REL_LIMIT):
            raise AssertionError(f"{name} card vs CPU: {row[name]}")
    with torch.no_grad():
        _, _, (z, _, z_same) = card_model.voice_conversion(
            on_card["spec"], on_card["y_lengths"], on_card["g_src"],
            on_card["g_src"], noise=on_card["noise"])
    z, _, z_other = card_out["voice_conversion"][2]
    row["voice_conversion_same_speaker_rel_l2"] = rel_l2(z_same, z)
    row["voice_conversion_other_speaker_rel_l2"] = rel_l2(z_other, z)
    if not row["voice_conversion_same_speaker_rel_l2"] <= LOGIT_REL_LIMIT:
        raise AssertionError(f"voice_conversion g_src == g_tgt: z_hat vs z "
                             f"{row['voice_conversion_same_speaker_rel_l2']}")
    return row


def reference_state_dict_from_port(model, cfg) -> dict:
    """A state_dict in the reference's SynthesizerTrn names and layouts
    (weight norm as weight_g / weight_v, LayerNorm as gamma / beta) that
    holds ``model``'s weights: compat.torch_import's key table read
    backwards. Written from random weights, it stands in for a reference
    .pth; nothing is downloaded."""
    import torch
    from music_generation_tpu_torch.compat import torch_import
    from music_generation_tpu_torch.compat.from_jax import _port_name
    rows = []

    class Keys(torch_import._Mapper):
        def __init__(self):
            self.sd, self.params, self.used = {}, {}, set()

        def copy(self, torch_key, flax_path, transform=None):
            rows.append((torch_key, flax_path, "copy"))

        def conv(self, tprefix, fpath, bias=True, weight_norm=False):
            rows.append((tprefix, fpath + ("kernel",), "conv"))

        def convT(self, tprefix, fpath):
            rows.append((tprefix, fpath + ("kernel",), "conv"))

    torch_import._flax_tree(Keys(), cfg)
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    out = {}
    for key, path, kind in rows:
        name = _port_name(path)
        if kind == "copy":
            out[key] = params[name].detach().cpu().clone()
            continue
        mod = modules[name.rpartition(".")[0]]
        if getattr(mod, "g", None) is not None:      # weight norm
            w = mod.effective_weight().detach().cpu()
            out[f"{key}.weight_v"] = w.clone()
            out[f"{key}.weight_g"] = w.flatten(1).norm(dim=1)[:, None, None]
        else:
            out[f"{key}.weight"] = mod.weight.detach().cpu().clone()
        if mod.bias is not None:
            out[f"{key}.bias"] = mod.bias.detach().cpu().clone()
    return out


def plain_reference_served(device) -> dict:
    """A plain (non-AE) reference .pth written from random full-width
    weights through tools/torch_import_pipeline.py --pth --no-autoencoder,
    into serve.app's construction with --checkpoint-dir: singer 0 rebuilt
    as the plain VISinger, every served tensor equal to the file's, one
    request served."""
    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig, VISinger
    from music_generation_tpu_torch.serve import app
    from tools.torch_import_pipeline import import_pth
    cfg = SVSConfig(autoencoder=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 5)
        model = VISinger(cfg)
    pth = SCRATCH / "G_plain.pth"
    pth.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": reference_state_dict_from_port(model, cfg),
                "iteration": 0}, pth)
    t0 = time.time()
    written = import_pth([str(pth)], str(SCRATCH / "plain"),
                         autoencoder=False)
    row = {"import_s": time.time() - t0}
    args, scfg = app.configure(["--checkpoint-dir", str(SCRATCH / "plain"),
                                "--device", str(device)])
    scfg.n_speakers = 1
    t0 = time.time()
    songs = app.build_songs(args, scfg, seed=SEED)
    torch.cuda.synchronize()
    row["build_and_load_s"] = time.time() - t0
    svs = songs.synthesizers[0]
    saved = torch.load(written[0], weights_only=True)
    if svs.cfg.autoencoder or not states_equal(state_on_host(svs.model),
                                               saved):
        raise AssertionError("the served singer is not the plain file's")
    row["tensors"] = len(saved)
    row["served"] = serve_once(songs, REQUESTS[1]["text"])
    return row


def phase_v1_model(device) -> dict:
    """Phase 13: serve.app --variant v1_model at full width (two
    MelodyConfig() TeleMelody twins, the three SVSConfig() singers from the
    serve phase's seed): a 4-sentence text cold and twice warm over HTTP,
    every sentence's notes and durations checked, a warm request's stage
    timings, launches and busy share; the song mixed against the vocal
    alone; the twins on the card against the CPU; the CLI's --score; the
    SVS probes card against CPU; the plain VISinger's infer card against
    CPU, a plain reference .pth through the import tool into the server;
    one plain full-width training step with MAS durations (the kernel
    twice)."""
    import shutil

    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.pipeline.synthesis import split_sentences
    from music_generation_tpu_torch.serve import app
    start = time.time()
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    rows, steps = {}, {}
    try:
        t0 = time.time()
        args, cfg = app.configure(["--variant", "v1_model", "--device",
                                   str(device)])
        songs = app.build_songs(args, cfg, seed=SEED)
        torch.cuda.synchronize()
        rows["build_s"] = time.time() - t0
        if not songs.mix_accompaniment:
            raise AssertionError("v1_model does not mix its accompaniment")
        recorder = MelodyRecorder(songs.melody, "generate")
        served = {"chars": len(V1_TEXT)}
        with http_service(songs) as (_, port):
            for kind in ("cold", "warm", "warm_2"):
                recorder.sentences.clear()
                t0 = time.time()
                out = _post(port, {"text": V1_TEXT})
                served[f"{kind}_s"] = time.time() - t0
                served["audio_s"] = check_song(f"v1_model {kind}", out)
                check_variant_melody("v1_model", recorder.sentences,
                                     sdp=False)
        served["sentences"] = [s[0] for s in recorder.sentences]
        served["notes_per_sentence"] = [len(s[1]) for s in
                                        recorder.sentences]
        served["profile"] = profile_request(songs, V1_TEXT)
        rows["served"] = served
        steps["served"] = time.time() - start
        if maximum_path.kernel_launches or maximum_path.plain_calls:
            raise AssertionError("v1_model's path ran MAS")
        rows["accompaniment"] = v1_accompaniment(songs)
        rows["telemelody"] = telemelody_on_card_and_cpu(
            songs.melody.gen, split_sentences(V1_TEXT))
        steps["telemelody"] = time.time() - start
        del songs, recorder
        torch.cuda.empty_cache()
        rows["score_cli"] = score_cli(device)
        steps["score_cli"] = time.time() - start
        rows["probes"] = svs_probes_card_vs_cpu(device)
        steps["probes"] = time.time() - start
        rows["plain_infer_card_vs_cpu_rel_l2"] = visinger_card_vs_cpu(
            device, SVSConfig(autoencoder=False))
        rows["plain_reference"] = plain_reference_served(device)
        steps["plain_reference"] = time.time() - start
        if maximum_path.kernel_launches or maximum_path.plain_calls:
            raise AssertionError("the served paths of phase 13 ran MAS")
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()
    train = decoder_train_steps(device, SVSConfig(autoencoder=False),
                                steps=1)
    if any("loss_spec" in losses for losses in train["losses_first_last"]):
        raise AssertionError("the plain VISinger's step has a loss_spec")
    rows["train_plain"] = train
    steps["train_plain"] = time.time() - start
    rows["steps_s"] = steps
    rows["phase_s"] = time.time() - start
    sv, pr, tm = rows["served"], rows["probes"], rows["telemelody"]
    log(f"v1_model phase ({rows['phase_s']:.1f} s): built in "
        f"{rows['build_s']:.1f} s; request cold {sv['cold_s']:.3f} s, warm "
        f"{sv['warm_s']:.3f} / {sv['warm_2_s']:.3f} s "
        f"({sv['audio_s']:.2f} s of audio); warm melody "
        f"{sv['profile']['melody_s']:.3f} s, svs {sv['profile']['svs_s']:.3f}"
        f" s, accompaniment {sv['profile']['accompaniment_s']:.3f} s, "
        f"{sv['profile']['kernel_launches']} launches, busy "
        f"{sv['profile']['device_busy_share']:.3f}; mixed song "
        f"{rows['accompaniment']['samples']} samples as the vocal's, "
        f"{rows['accompaniment']['samples_changed_share']:.3f} of them "
        f"changed; TeleMelody card vs CPU "
        f"{json.dumps(tm['logprobs_rel_l2'])}; --score "
        f"{rows['score_cli']['cli_s']:.1f} s; probes card vs CPU audio "
        + ", ".join(f"{k} {pr[k]['audio_rel_l2']:.3e}" for k in
                    ("infer_fake", "copy_synthesis", "voice_conversion"))
        + f", same speaker z_hat vs z "
        f"{pr['voice_conversion_same_speaker_rel_l2']:.3e}; plain infer "
        f"{rows['plain_infer_card_vs_cpu_rel_l2']:.3e}; plain .pth served "
        f"({rows['plain_reference']['tensors']} tensors equal); plain step "
        f"{train['cold_ms']:.1f} ms, MAS {train['mas_launches']} launches")
    log("v1_model phase: " + json.dumps(rows, ensure_ascii=False))
    return rows


TOY_UTTS, TOY_SYLLABLES = 32, 6   # train.toydata's CLI defaults
LONG_UTTS, LONG_SYLLABLES = 8, 24  # 6-12 s each: past the 480-frame batch
CORPUS_STEPS = 4                  # --packed steps; then 1 with --data-dir
SHELL_TEXT = "你好世界，隐形的翅膀带我飞过绝望"
SHELL_RAW = "小小的天有大大的梦想\n重重的壳裹着轻轻的仰望"
DIFFRHYTHM_STUB = """import argparse, os, wave
import numpy as np
p = argparse.ArgumentParser()
for a in ("--lrc-path", "--ref-prompt", "--audio-length", "--repo-id",
          "--output-dir", "--batch-infer-num"):
    p.add_argument(a)
p.add_argument("--chunked", action="store_true")
a = p.parse_args()
n = 44100 * int(a.audio_length)
tone = (8000 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100)).astype("<i2")
with wave.open(os.path.join(a.output_dir, "song_0.wav"), "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(44100)
    w.writeframes(tone.tobytes())
"""


@contextlib.contextmanager
def trainer_probe():
    """Watch the trainer CLI from inside: the states and TrainConfig it
    builds (create_states), each step's wall between two
    torch.cuda.synchronize() (make_train_step's step) and the first MAS
    input of the run (mas_neg_cent). Yields the dict they land in."""
    import torch
    from music_generation_tpu_torch.ops import monotonic_align
    from music_generation_tpu_torch.train import trainer
    probe = {"step_ms": []}
    create, make = trainer.create_states, trainer.make_train_step
    neg_cent_fn = monotonic_align.mas_neg_cent

    def create_states(svs_cfg, tcfg, device=None):
        probe["svs_cfg"], probe["tcfg"] = svs_cfg, tcfg
        probe["states"] = create(svs_cfg, tcfg, device)
        return probe["states"]

    def make_train_step(svs_cfg, tcfg, *rest):
        step = make(svs_cfg, tcfg, *rest)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kwargs)
            torch.cuda.synchronize()
            probe["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def capture(*args, **kwargs):
        out = neg_cent_fn(*args, **kwargs)
        probe.setdefault("neg_cent", tuple(x.clone() for x in out))
        return out

    trainer.create_states, trainer.make_train_step = create_states, \
        make_train_step
    monotonic_align.mas_neg_cent = capture
    try:
        yield probe
    finally:
        trainer.create_states, trainer.make_train_step = create, make
        monotonic_align.mas_neg_cent = neg_cent_fn


def kernel_equals_plain(neg_cent, mask, what: str) -> list:
    """The MAS kernel against the plain version on one input, bit for bit
    (comparison launches, read after a phase's counts). Returns the
    input's shape."""
    import torch
    from music_generation_tpu_torch.ops import maximum_path, maximum_path_torch
    got = maximum_path(neg_cent, mask)
    want = maximum_path_torch(neg_cent, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"maximum_path kernel disagrees with the plain "
                             f"version on {what}")
    return list(neg_cent.shape)


def corpus_train_run(device, flag: str, source: str, steps: int,
                     ckpt_dir: Path) -> tuple[dict, dict]:
    """The port's trainer CLI (train.__main__.main) on the card at full
    width with --durations mas --log-images on a corpus: losses finite,
    the MAS kernel twice per step and the plain version never, the JSONL
    and the images written; ms per step, peak memory. Returns (row,
    trainer_probe's dict)."""
    import torch
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.train.__main__ import main as train_main
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with trainer_probe() as probe:
        train_main(["--device", str(device), "--durations", "mas",
                    "--log-images", "--steps", str(steps), "--batch-size",
                    str(TRAIN_BATCH), "--log-every", "2", "--ckpt-dir",
                    str(ckpt_dir), flag, source])
    wall = time.time() - t0
    launches, plain = maximum_path.kernel_launches, maximum_path.plain_calls
    if launches != 2 * steps or plain:
        raise AssertionError(f"{flag}: {steps} steps launched the MAS "
                             f"kernel {launches} times (plain {plain}); want "
                             f"{2 * steps} and 0")
    with open(ckpt_dir / "logs" / "train_metrics.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    if [r["step"] for r in rows] != list(range(0, steps, 2)) or not all(
            np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"{flag}: metrics rows {rows}")
    # one PNG (or .npy without matplotlib) per image and logged step
    images = sorted(os.listdir(ckpt_dir / "logs" / "images"))
    want = sorted(f"img_{k}_{r['step']}" for r in rows
                  for k in ("alignment", "mel_predict", "spec_predict",
                            "spec_target"))
    if sorted(os.path.splitext(f)[0] for f in images) != want or not all(
            f.endswith((".png", ".npy")) for f in images):
        raise AssertionError(f"{flag}: images {images}")
    if not (ckpt_dir / f"step_{steps}.pt").exists():
        raise AssertionError(f"{flag}: no step_{steps}.pt")
    return {"flag": flag, "steps": steps, "wall_s": wall,
            "steps_per_epoch": probe["tcfg"].steps_per_epoch,
            "step_ms": probe["step_ms"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "mas_launches": launches, "images": images,
            "losses_first": {k: v for k, v in rows[0].items()
                             if k.startswith("loss")}}, probe


def phase_corpus(device) -> dict:
    """Phase 14a: the native host library, two toy corpora preprocessed
    (YIN through the native code) and packed, the first batch of each
    reader, then full-width corpus training through the trainer CLI."""
    import shutil

    import torch
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.ops import build, mas_neg_cent
    from music_generation_tpu_torch.runtime import native_loader
    from music_generation_tpu_torch.train import to_device, tool_shapes
    from music_generation_tpu_torch.train.dataset import (NpyDataset,
                                                          PackedDataset,
                                                          pack_dataset)
    from music_generation_tpu_torch.train.toydata import make_toy_dataset
    start = time.time()
    rows = {}
    t0 = time.time()
    if not native_loader.native_available():
        raise AssertionError(f"native library did not build: "
                             f"{native_loader.build_error}")
    lib = native_loader.library
    if lib.parent != build.BUILD_DIR or not lib.exists():
        raise AssertionError(f"native library at {lib}")
    rows["native"] = {"build_s": native_loader.build_seconds,
                      "load_s": time.time() - t0, "library": lib.name,
                      "openmp": native_loader.openmp,
                      "omp_failure": native_loader.build_error}
    root = SCRATCH / "corpus"
    shutil.rmtree(root, ignore_errors=True)
    try:
        yin0 = native_loader.native_calls["yin_f0"]
        corpora = {}
        for tag, n, syl, seed in (("toy", TOY_UTTS, TOY_SYLLABLES, SEED),
                                  ("long", LONG_UTTS, LONG_SYLLABLES,
                                   SEED + 1)):
            t0 = time.time()
            npy = make_toy_dataset(str(root / tag), n_utts=n, syllables=syl,
                                   seed=seed)
            prep_s = time.time() - t0
            t0 = time.time()
            prefix = str(root / f"{tag}_packed")
            if pack_dataset(npy, prefix) != n:
                raise AssertionError(f"{tag}: packed count")
            wav_s = sum(np.load(os.path.join(npy, f)).size
                        for f in os.listdir(npy) if f.endswith("-wav.npy")
                        ) / 22050
            corpora[tag] = {
                "npy": npy, "packed": prefix, "utterances": n,
                "syllables": syl, "audio_s": wav_s, "preprocess_s": prep_s,
                "pack_s": time.time() - t0,
                "npy_bytes": sum(os.path.getsize(os.path.join(npy, f))
                                 for f in os.listdir(npy)),
                "packed_bytes": os.path.getsize(prefix + ".data")
                + os.path.getsize(prefix + ".idx")}
        yin_calls = native_loader.native_calls["yin_f0"] - yin0
        if yin_calls != TOY_UTTS + LONG_UTTS:
            raise AssertionError(f"YIN took the native code {yin_calls} "
                                 f"times for {TOY_UTTS + LONG_UTTS} "
                                 f"utterances")
        rows["corpora"] = {k: {kk: vv for kk, vv in v.items()
                               if kk not in ("npy", "packed")}
                           for k, v in corpora.items()}

        cfg = SVSConfig()
        phones, frames = tool_shapes(False)
        toy, long_ = corpora["toy"], corpora["long"]
        npy_ds = NpyDataset(toy["npy"], cfg, t_phones=phones,
                            t_frames=frames, seed=0)
        packed_ds = PackedDataset(toy["packed"], cfg, t_phones=phones,
                                  t_frames=frames, seed=0)
        if not packed_ds._ds.native:
            raise AssertionError("PackedDataset took the Python reader")
        gather0 = native_loader.native_calls["read_batch"]
        first, first_packed = (npy_ds.batch(TRAIN_BATCH),
                               packed_ds.batch(TRAIN_BATCH))
        if native_loader.native_calls["read_batch"] != gather0 + 1:
            raise AssertionError("the packed batch took no native gather")
        if first.keys() != first_packed.keys() or not all(
                np.array_equal(first[k], first_packed[k]) for k in first):
            raise AssertionError("the first PackedDataset batch differs "
                                 "from the NpyDataset batch of seed 0")
        rows["first_batch"] = {"x_lengths": first["x_lengths"].tolist(),
                               "y_lengths": first["y_lengths"].tolist()}
        rows["batch_ms"] = {
            name: host_ms(lambda: ds.batch(TRAIN_BATCH), reps=5)
            for name, ds in (("npy", npy_ds), ("packed", packed_ds))}
        packed_ds.close()

        runs = {}
        runs["packed"], probe = corpus_train_run(
            device, "--packed", toy["packed"], CORPUS_STEPS,
            root / "ck_packed")
        shutil.rmtree(root / "ck_packed")  # a 1.2 GB step file
        neg_cent, mask = probe["neg_cent"]
        del probe
        torch.cuda.empty_cache()
        runs["npy"], probe = corpus_train_run(
            device, "--data-dir", toy["npy"], 1, root / "ck_npy")
        # the corpus and this MAS-trained step file feed phase 16's tools
        KEPT.mkdir(parents=True, exist_ok=True)
        shutil.move(str(root / "ck_npy" / "step_1.pt"),
                    str(KEPT / "step_1.pt"))
        shutil.rmtree(root / "ck_npy")
        shutil.move(toy["npy"], str(KEPT / "npy"))
        for run in runs.values():
            if run["steps_per_epoch"] != TOY_UTTS // TRAIN_BATCH:
                raise AssertionError(f"steps_per_epoch "
                                     f"{run['steps_per_epoch']}")
        if runs["npy"]["losses_first"] != runs["packed"]["losses_first"]:
            raise AssertionError("the two readers' first steps differ: "
                                 f"{runs['npy']['losses_first']} "
                                 f"{runs['packed']['losses_first']}")
        rows["train"] = runs
        rows["mas_launches"] = sum(r["mas_launches"] for r in runs.values())
        rows["kernel_vs_plain"] = {"corpus_step": kernel_equals_plain(
            neg_cent, mask, "a corpus step's neg_cent")}
        rows["corpus_step_lengths"] = {
            "frames": mask[:, :, 0].sum(1).int().tolist(),
            "phones": mask[:, 0, :].sum(1).int().tolist()}
        # a batch of the long corpus (every utterance past 480 frames, cut)
        # through the trained generator's MAS inputs
        long_ds = PackedDataset(long_["packed"], cfg, t_phones=phones,
                                t_frames=frames, seed=SEED)
        lb = long_ds.batch(TRAIN_BATCH)
        long_ds.close()
        if not (lb["y_lengths"] == frames).all():
            raise AssertionError(f"long corpus y_lengths {lb['y_lengths']}")
        gen = probe["states"][0].model
        b = to_device(lb, device)
        with torch.no_grad():
            z_p, m, logs, x_mask, y_mask = gen.mas_inputs(
                b["phones"], b["x_lengths"], b["note_ids"],
                b["note_durations"], b["shengdiao"], b["spec"],
                b["y_lengths"])
            nc, am = mas_neg_cent(z_p, m, logs, x_mask, y_mask)
        rows["kernel_vs_plain"]["long_batch"] = kernel_equals_plain(
            nc, am, "a long-corpus batch's neg_cent")
        rows["long_batch"] = {"x_lengths": lb["x_lengths"].tolist(),
                              "y_lengths": lb["y_lengths"].tolist()}
        del probe, gen, b, neg_cent, mask, nc, am
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    rows["phase_s"] = time.time() - start
    pk, tr = rows["corpora"], rows["train"]["packed"]
    warm = float(np.median(tr["step_ms"][1:]))
    rows["warm_ms_per_step"] = warm
    built = rows["native"]["build_s"]
    log(f"corpus phase ({rows['phase_s']:.1f} s): native library "
        f"{rows['native']['library']} "
        + (f"built in {built:.2f} s" if built is not None
           else "found built")
        + f" ({'with' if rows['native']['openmp'] else 'without'} OpenMP)"
        + "; corpora: "
        + ", ".join(f"{k} {v['utterances']} x {v['syllables']} syllables "
                    f"({v['audio_s']:.1f} s of audio, preprocessed in "
                    f"{v['preprocess_s']:.2f} s, packed "
                    f"{v['packed_bytes']:,} bytes)" for k, v in pk.items())
        + f"; first batch x_lengths {rows['first_batch']['x_lengths']} "
        f"y_lengths {rows['first_batch']['y_lengths']}, packed == npy; "
        f"batch read npy {rows['batch_ms']['npy']:.1f} ms, packed "
        f"{rows['batch_ms']['packed']:.1f} ms; --packed {CORPUS_STEPS} "
        f"steps: cold {tr['step_ms'][0]:.1f} ms, warm {warm:.1f} ms per "
        f"step, peak {tr['peak_memory_bytes'] / 2 ** 30:.2f} GiB, "
        f"steps_per_epoch {tr['steps_per_epoch']}; --data-dir 1 step "
        f"{rows['train']['npy']['step_ms'][0]:.1f} ms, first-step losses "
        f"equal; MAS kernel {rows['mas_launches']} launches, plain 0; "
        f"kernel == plain on a corpus step "
        f"{rows['kernel_vs_plain']['corpus_step']} and a long batch "
        f"{rows['kernel_vs_plain']['long_batch']}")
    return rows


def shell_request(port, payload: dict, tag: str) -> tuple[dict, float]:
    t0 = time.time()
    out = _post(port, payload)
    wall = time.time() - t0
    if out.get("code") != 200:
        raise AssertionError(f"{tag}: {out}")
    return out, wall


def shell_answer(out: dict, tag: str) -> dict:
    """A shell-path answer: mode, lyrics, lrc and a 44.1 kHz WAV."""
    from scipy.io import wavfile
    data = out["data"]
    if not (data.get("mode") and data["lyrics"] and
            data["lrc"].startswith("[00:00.00] ")):
        raise AssertionError(f"{tag}: {data.keys()} {data.get('lrc')!r}")
    audio = base64.b64decode(data["audio"])
    rate, wav = wavfile.read(io.BytesIO(audio))
    if rate != 44100:
        raise AssertionError(f"{tag}: rate {rate}")
    return {"mode": data["mode"], "lines": data["lyrics"].count("\n") + 1,
            "audio_bytes": len(audio), "audio_s": len(wav) / rate}


def phase_v1_shell(device) -> dict:
    """Phase 14b: serve.app's own construction with --variant v1 (the
    full-width T5 as the shell's lyric_fn, MelodyConfig() and three
    SVSConfig() singers behind the fallback) and once with
    MUSIC_BACKEND=new and a stub $DIFFRHYTHM_REPO; requests over HTTP
    through the shell and through the fallback."""
    import shutil

    import torch
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.serve import app
    start = time.time()
    if shutil.which("ollama"):
        raise AssertionError("ollama is on PATH: the lyrics would not come "
                             "from the T5 on the card")
    root = SCRATCH / "shell"
    shutil.rmtree(root, ignore_errors=True)
    stub = root / "diffrhythm"
    (stub / "infer").mkdir(parents=True)
    (stub / "infer" / "infer.py").write_text(DIFFRHYTHM_STUB)
    rows, requests = {}, {}
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    try:
        t0 = time.time()
        args, cfg = app.configure(["--variant", "v1", "--device",
                                   str(device)])
        service = app.build_service(args, cfg)
        torch.cuda.synchronize()
        rows["build_s"] = time.time() - t0
        shell = service.shell_backend
        if cfg.backend != "shell" or shell.diffrhythm_repo:
            raise AssertionError(f"v1 backend {cfg.backend}, DiffRhythm "
                                 f"{shell.diffrhythm_repo}")
        if sorted(service.songs.synthesizers) != [0, 1, 2]:
            raise AssertionError("v1 is not served by three singers")
        shell.root = str(root / "v1")
        clock = StageClock(service.lyrics)
        shell.lyric_fn = clock.generate
        with serving(service) as port:
            out, wall = shell_request(port, {"keyword": "夏天"}, "keyword")
            requests["keyword"] = {"wall_s": wall, "path": "shell",
                                   **shell_answer(out, "keyword")}
            if len(clock.seconds) != 1:
                raise AssertionError(f"lyric_fn called "
                                     f"{len(clock.seconds)} times")
            requests["keyword"]["lyric_s"] = clock.seconds[0]
            out, wall = shell_request(port, {"raw_lyrics": SHELL_RAW},
                                      "raw_lyrics")
            if out["data"]["lyrics"] != SHELL_RAW or len(clock.seconds) != 1:
                raise AssertionError(f"raw_lyrics: {out['data']['lyrics']!r}"
                                     f", lyric_fn {len(clock.seconds)}")
            requests["raw_lyrics"] = {"wall_s": wall, "path": "shell",
                                      **shell_answer(out, "raw_lyrics")}
            # a shell run that raises: its root is a file
            (root / "a_file").write_text("not a directory")
            shell.root = str(root / "a_file")
            for kind in ("fallback_cold", "fallback_warm"):
                out, wall = shell_request(port, {"text": SHELL_TEXT}, kind)
                if "mode" in out["data"]:
                    raise AssertionError(f"{kind}: answered by the shell")
                requests[kind] = {"wall_s": wall, "path": "model",
                                  "audio_s": check_song(kind, out)}
            requests["fallback_warm"]["profile"] = profiled(
                lambda: service.handle_synthesis({"text": SHELL_TEXT}))
        rows["lyric_fn_calls"] = len(clock.seconds)
        del service, clock, shell
        torch.cuda.empty_cache()

        t0 = time.time()
        env = {"MUSIC_BACKEND": "new", "DIFFRHYTHM_REPO": str(stub)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            args, cfg = app.configure(["--device", str(device)])
            service = app.build_service(args, cfg)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        rows["music_backend_new_build_s"] = time.time() - t0
        if cfg.backend != "shell" or args.variant != "svs_v6_multispeaker":
            raise AssertionError(f"MUSIC_BACKEND=new: {cfg.backend}")
        service.shell_backend.root = str(root / "new")
        with serving(service) as port:
            out, wall = shell_request(
                port, {"keyword": "星空", "audio_length": 2}, "diffrhythm")
            made = list((root / "new" / "requests" / "REQ-00001" /
                         "diffrhythm_output").glob("*.wav"))
            if len(made) != 1 or base64.b64decode(out["data"]["audio"]) \
                    != made[0].read_bytes():
                raise AssertionError("the stub DiffRhythm's WAV did not "
                                     "come back")
            requests["diffrhythm"] = {"wall_s": wall,
                                      "path": "shell + DiffRhythm stub",
                                      **shell_answer(out, "diffrhythm")}
        del service
        if maximum_path.kernel_launches or maximum_path.plain_calls:
            raise AssertionError("the v1 served path ran MAS")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    rows["requests"] = requests
    rows["phase_s"] = time.time() - start
    fb = requests["fallback_warm"]["profile"]
    log(f"v1 shell phase ({rows['phase_s']:.1f} s): --variant v1 built in "
        f"{rows['build_s']:.1f} s, MUSIC_BACKEND=new in "
        f"{rows['music_backend_new_build_s']:.1f} s; "
        + "; ".join(f"{k} {v['wall_s']:.3f} s via {v['path']}"
                    + (f" (mode {v['mode']})" if "mode" in v else "")
                    for k, v in requests.items())
        + f"; T5 lyric_fn called {rows['lyric_fn_calls']} time(s), "
        f"{requests['keyword']['lyric_s']:.3f} s; warm fallback profiled "
        f"{fb['profiled_s']:.3f} s, device busy {fb['device_busy_share']:.3f}"
        f", {fb['kernel_launches']} launches")
    return rows


def phase_corpus_and_v1(device) -> dict:
    """Phase 14: corpus training (14a), then v1 served (14b)."""
    start = time.time()
    rows = {"corpus": phase_corpus(device), "v1_shell": phase_v1_shell(device)}
    rows["phase_s"] = time.time() - start
    log("corpus and v1 phase: " + json.dumps(rows, ensure_ascii=False))
    return rows


SEQ_BATCH = 16            # train.seq's --batch-size default
SEQ_STEPS = 7             # one cold, five warm (timed), one profiled
SEQ_MAX_STEPS = 40        # the most steps a family takes to show its
                          # loss below its first
SEQ_LOSS_REL_LIMIT = 1e-4  # card against CPU, each family's first loss
BF16_LOSS_REL_LIMIT = 0.2  # each bf16 loss term against float32's (the
                           # JAX package's tests/test_train.py bound)
BF16_STEPS = 4            # one cold, three warm


def seq_cpu_twin(family, model):
    """The family's model at dropout 0 on the CPU, the card model's full
    config, except t5 at 2 of its 12 encoder and decoder layers (a
    full-width CPU forward of its 239 M parameters takes too long here).
    Returns (cpu model, note)."""
    import dataclasses

    import torch
    from music_generation_tpu_torch.models.lyrics import T5
    from music_generation_tpu_torch.train import seq
    if family == "t5":
        cfg = dataclasses.replace(model.cfg, num_layers=2,
                                  num_decoder_layers=2)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            return T5(cfg), "2 of 12 encoder and decoder layers"
    cpu, _, _ = seq.build_family(family, False, None, SEED, "cpu")
    for m in cpu.modules():  # dropout off: every rate 0
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return cpu, "full width"


def seq_family_run(device, family) -> dict:
    """One train.seq family at its default (full) config on the card: its
    first loss against a CPU twin (dropout 0, same weights and batch, the
    SDP's posterior noise injected), then SEQ_STEPS training steps with
    dropout on through make_seq_train_step: warm ms, peak memory,
    launches of a profiled step, the loss falling."""
    import copy as copy_mod

    import torch
    from music_generation_tpu_torch.train import seq, to_device
    from music_generation_tpu_torch.train.seq_losses import (
        SeqOptimizer, make_seq_train_step)
    t0 = time.time()
    model, loss_fn, batcher = seq.build_family(family, False, None, SEED,
                                               device)
    n_params = sum(p.numel() for p in model.parameters())
    cpu, note = seq_cpu_twin(family, model)
    card = copy_mod.deepcopy(cpu).to(device)
    batch = batcher.batch(SEQ_BATCH)
    if family == "duration_sdp":
        batch["e_q"] = np.random.RandomState(SEED).randn(
            *batch["src"].shape, 2).astype(np.float32)
    with torch.no_grad():
        want = float(loss_fn(cpu, to_device(batch, "cpu"),
                             torch.Generator().manual_seed(SEED)))
        got = float(loss_fn(card, to_device(batch, device),
                            torch.Generator(device).manual_seed(SEED)))
    rel = abs(got - want) / abs(want)
    if not rel < SEQ_LOSS_REL_LIMIT:
        raise AssertionError(f"{family}: first loss card {got} CPU {want}")
    del cpu, card
    build_s = time.time() - t0

    opt = SeqOptimizer(model.parameters(), 3e-4)
    step = make_seq_train_step(loss_fn, model, opt)
    generator = torch.Generator(device).manual_seed(SEED + 1)
    batches = [to_device(batcher.batch(SEQ_BATCH), device)
               for _ in range(SEQ_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(SEQ_STEPS - 1):
        t1 = time.perf_counter()
        losses.append(step(batches[i], generator))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    prof = profiled(lambda: losses.append(step(batches[-1], generator)))
    losses = [float(x) for x in losses]
    # a family whose loss has not fallen below its first in SEQ_STEPS
    # steps trains on (untimed) until it does, up to SEQ_MAX_STEPS
    while not losses[-1] < losses[0] and len(losses) < SEQ_MAX_STEPS:
        losses.append(float(step(to_device(batcher.batch(SEQ_BATCH),
                                           device), generator)))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{family}: losses {losses}")
    return {"family": family, "parameters": n_params,
            "first_loss_card": got, "first_loss_cpu": want,
            "first_loss_rel": rel, "cpu_twin": note,
            "cold_ms": times[0], "warm_ms": times[1:],
            "ms_per_step": float(np.median(times[1:])),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": prof["kernel_launches"],
            "device_busy_share": prof["device_busy_share"],
            "top_kernels": prof["top_kernels"][:3], "losses": losses,
            "steps_to_fall": len(losses) - 1,
            "build_and_compare_s": build_s}


def bf16_train_run(device, f32_row: dict) -> dict:
    """The trainer CLI with --bf16 --durations mas at full width, B=8
    (BF16_STEPS steps), against a float32 step on the same weights
    (create_states' seed), batch (the CLI's first, synthetic seed 0) and
    generator (the trainer's seed): every loss term within
    BF16_LOSS_REL_LIMIT, the masters float32 and moved, MAS twice per
    step, and the kernel bit for bit against the plain version on the
    bf16 step's neg_cent cast to float32. Beside it phase 8's float32 ms
    and peak memory."""
    import shutil

    import torch
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.train import (TrainConfig,
                                                  build_svs_config,
                                                  create_states,
                                                  make_train_step,
                                                  synthetic_batch, to_device,
                                                  tool_shapes)
    from music_generation_tpu_torch.train.__main__ import main as train_main
    # the CLI's configuration at full width
    cfg = build_svs_config(tiny=False)
    tc = TrainConfig(use_mas=True, warmup_steps=0)
    phones, frames = tool_shapes(False)
    gen_state, disc_state = create_states(cfg, tc, device)
    before = {f"{tag}.{n}": p.detach().clone()
              for tag, st in (("gen", gen_state), ("disc", disc_state))
              for n, p in st.model.named_parameters()}
    batch = to_device(synthetic_batch(cfg, batch=TRAIN_BATCH,
                                      t_phones=phones, t_frames=frames,
                                      seed=0), device)
    f32 = {k: float(v) for k, v in make_train_step(cfg, tc)(
        gen_state, disc_state, batch,
        torch.Generator(device).manual_seed(tc.seed)).items()}
    del gen_state, disc_state, batch
    torch.cuda.empty_cache()

    ckpt_dir = SCRATCH / "bf16"
    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        with trainer_probe() as probe:
            train_main(["--device", str(device), "--bf16", "--durations",
                        "mas", "--steps", str(BF16_STEPS), "--batch-size",
                        str(TRAIN_BATCH), "--log-every", "1",
                        "--warmup-steps", "0", "--ckpt-dir", str(ckpt_dir)])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = maximum_path.kernel_launches
        plain = maximum_path.plain_calls
        with open(ckpt_dir / "logs" / "train_metrics.jsonl") as fh:
            first = json.loads(fh.readline())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # a 1.2 GB step file
    if launches != 2 * BF16_STEPS or plain:
        raise AssertionError(f"--bf16: {BF16_STEPS} steps launched the MAS "
                             f"kernel {launches} times (plain {plain})")
    rel = {k: abs(first[k] - v) / (abs(v) + 1e-3) for k, v in f32.items()}
    if not all(np.isfinite(first[k]) for k in f32) or \
            max(rel.values()) >= BF16_LOSS_REL_LIMIT:
        raise AssertionError(f"--bf16 first step {first} against float32 "
                             f"{f32}")
    states = probe["states"]
    masters = {p.dtype for st in states for p in st.model.parameters()}
    moved = sum(not torch.equal(before[f"{tag}.{n}"], p)
                for tag, st in zip(("gen", "disc"), states)
                for n, p in st.model.named_parameters())
    if masters != {torch.float32} or not moved:
        raise AssertionError(f"--bf16 masters {masters}, {moved} moved")
    del before, probe["states"]
    neg_cent, attn = probe["neg_cent"]
    shape = kernel_equals_plain(neg_cent.float(), attn.float(),
                                "a --bf16 step's neg_cent")
    # the share of each item's scores that repeat a value of the item
    ties = float(np.mean([1 - torch.unique(r).numel() / r.numel()
                          for r in neg_cent.float().flatten(1).cpu()]))
    warm = probe["step_ms"][1:]
    return {"steps": BF16_STEPS, "wall_s": wall,
            "cold_ms": probe["step_ms"][0], "warm_ms": warm,
            "ms_per_step": float(np.median(warm)),
            "f32_ms_per_step_phase8": f32_row["ms_per_step"],
            "peak_memory_bytes": peak,
            "f32_peak_memory_bytes_phase8": f32_row["peak_memory_bytes"],
            "loss_rel_to_f32": rel, "loss_rel_max": max(rel.values()),
            "losses_first_bf16": {k: first[k] for k in f32},
            "losses_first_f32": f32, "masters": str(masters.pop()),
            "parameters_moved": moved, "mas_launches": launches,
            "neg_cent_dtype": str(neg_cent.dtype),
            "neg_cent_repeated_share": ties, "neg_cent_shape": shape}


def melody_export_served(device) -> dict:
    """melody_note and duration_mse trained 3 steps at full width
    (train_family, B=16, checkpoints), exported by
    tools/torch_export_trained_melody.py, loaded by load_pipeline into the
    full-width served melody generator (from another seed): every tensor
    equal to the trained modules', and the served notes and durations of
    a text equal to those of the trained modules run directly."""
    import shutil
    import types

    import torch
    from music_generation_tpu_torch.compat import load_pipeline
    from music_generation_tpu_torch.pipeline.synthesis import \
        build_melody_generator
    from music_generation_tpu_torch.train import seq
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_export_trained_melody
    root = SCRATCH / "melody"
    t0 = time.time()
    try:
        trained = {fam: seq.train_family(
            fam, steps=3, ckpt_dir=str(root / "ck"), seed=SEED,
            device=device, return_model=True, log_every=10)[1]
            for fam in ("melody_note", "duration_mse")}
        torch_export_trained_melody.main([
            "--notes", str(root / "ck" / "melody_note" / "step_3.pt"),
            "--duration", str(root / "ck" / "duration_mse" / "step_3.pt"),
            "--out", str(root / "served")])
        served = build_melody_generator(seed=SEED + 5, device=device)
        loaded = load_pipeline(str(root / "served"), types.SimpleNamespace(
            synthesizers={}, melody=served))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if loaded != ["melody_notes.pt", "melody_duration.pt"]:
        raise AssertionError(f"load_pipeline loaded {loaded}")
    direct = build_melody_generator(seed=SEED + 6, device=device)
    direct.note_model = trained["melody_note"].eval()
    direct.duration_model = trained["duration_mse"].eval()
    equal = sum(torch.equal(a, b) for m in ("note_model", "duration_model")
                for a, b in zip(getattr(served, m).state_dict().values(),
                                getattr(direct, m).state_dict().values()))
    total = sum(len(getattr(served, m).state_dict())
                for m in ("note_model", "duration_model"))
    text = BENCH_SENTENCES[0]
    got, want = served.generate(text), direct.generate(text)
    if equal != total or got != want:
        raise AssertionError(f"served melody differs from the trained one: "
                             f"{equal}/{total} tensors, {got} != {want}")
    return {"tensors_equal": equal, "text": text, "notes": got[1],
            "durations": got[2], "wall_s": time.time() - t0}


def phase_seq_train(device, f32_row: dict) -> dict:
    """Phase 15: the eight train.seq families (15a), --bf16 (15b), the
    exported melody served (15c)."""
    import torch
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.train import seq
    start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {"families": []}
    maximum_path.kernel_launches = 0
    for fam in seq.FAMILIES:
        rows["families"].append(seq_family_run(device, fam))
        r = rows["families"][-1]
        log(f"seq phase: {fam}: {r['parameters']:,} parameters, first loss "
            f"card vs CPU {r['first_loss_rel']:.3e} ({r['cpu_twin']}), warm "
            f"{r['ms_per_step']:.1f} ms per step, peak "
            f"{r['peak_memory_bytes'] / 2 ** 30:.2f} GiB, "
            f"{r['launches_per_step']} launches per step, loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} after "
            f"{r['steps_to_fall']} steps")
        torch.cuda.empty_cache()
    if maximum_path.kernel_launches:
        raise AssertionError("a train.seq family launched MAS")
    rows["bf16"] = bf16_train_run(device, f32_row)
    b = rows["bf16"]
    log(f"seq phase: --bf16 --durations mas: warm {b['ms_per_step']:.1f} ms "
        f"per step (float32 in phase 8: {b['f32_ms_per_step_phase8']:.1f}), "
        f"peak {b['peak_memory_bytes'] / 2 ** 30:.2f} GiB (float32 "
        f"{b['f32_peak_memory_bytes_phase8'] / 2 ** 30:.2f}), loss terms "
        f"within {b['loss_rel_max']:.4f} of float32, masters {b['masters']}"
        f", MAS {b['mas_launches']} launches, kernel == plain on the bf16 "
        f"step's {b['neg_cent_dtype']} neg_cent")
    torch.cuda.empty_cache()
    rows["export"] = melody_export_served(device)
    rows["phase_s"] = time.time() - start
    log("seq phase: " + json.dumps(rows, ensure_ascii=False))
    return rows


PARALLEL_STEPS = 4        # the one-rank trainer CLI's steps in phase 16:
                          # cold, two warm (timed), one profiled


def collective_counts(prof) -> dict:
    """Collective calls recorded by torch.profiler: the host's c10d ops
    (one per collective; each also records an "nccl:" span) and device
    kernels whose names carry "nccl"."""
    from torch.autograd import DeviceType
    host, device = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if "nccl" in name.lower():
                device[name[:60]] = device.get(name[:60], 0) + 1
        elif name.startswith("c10d::"):
            host[name] = host.get(name, 0) + 1
    return {"host_ops": host, "device_kernels": device,
            "host_total": sum(host.values()),
            "device_total": sum(device.values())}


def deterministic(on: bool = True):
    """torch's deterministic algorithms (warnings, not errors, where an op
    has none) and cuDNN's, no autotuning: two runs of one step on one card
    then differ only where the code differs."""
    import torch
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def train_rank(out: str, argv: list) -> int:
    """``python3 chip_smoke.py --train-rank OUT.json -- ARGV``: the
    trainer CLI (train.__main__.main(ARGV)) in this process, watched:
    trainer_probe's step walls and first MAS input, the MAS kernel's
    launches and plain calls over the run, the collectives of its last
    step under torch.profiler, and the kernel against the plain version on
    the captured neg_cent (after the counts are read). Writes OUT.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.train import trainer
    from music_generation_tpu_torch.train.__main__ import main as train_main
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic()
    report = {}

    def make_profiled(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = []

        def run(*a, **k):
            calls.append(1)
            if len(calls) != PARALLEL_STEPS:
                return step(*a, **k)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = step(*a, **k)
                torch.cuda.synchronize()
            report["collectives_step"] = collective_counts(prof)
            return out
        return run

    maximum_path.kernel_launches = 0
    maximum_path.plain_calls = 0
    with trainer_probe() as probe:
        make = trainer.make_train_step        # the probe's timed one
        trainer.make_train_step = make_profiled
        try:
            train_main(argv)
        finally:
            trainer.make_train_step = make
        report["mas_launches"] = maximum_path.kernel_launches
        report["mas_plain_calls"] = maximum_path.plain_calls
        report["step_ms"] = probe["step_ms"]
        neg_cent, mask = probe["neg_cent"]
    report["kernel_vs_plain"] = kernel_equals_plain(
        neg_cent, mask, "the one-rank NCCL step's neg_cent")
    report["neg_cent_dtype"] = str(neg_cent.dtype)
    with open(out, "w") as fh:
        json.dump(report, fh)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loss_gap(rows: list, ref: list, keys: list) -> tuple[float, list]:
    """(max relative difference, ["step:term" not bit-equal]) of two
    runs' metrics rows; raises on a non-finite term or other steps."""
    rel, unequal = 0.0, []
    for a, b in zip(rows, ref):
        if a["step"] != b["step"]:
            raise AssertionError("the two runs logged different steps")
        for k in keys:
            if not np.isfinite(a[k]):
                raise AssertionError(f"step {a['step']}: {k} = {a[k]}")
            if a[k] != b[k]:
                unequal.append(f"{a['step']}:{k}")
                rel = max(rel, abs(a[k] - b[k]) / max(abs(b[k]), 1e-12))
    return rel, unequal


def parallel_trainer(device, f32_row: dict) -> dict:
    """Phase 16a: the trainer CLI at full width as a one-rank NCCL group
    (--multihost --coordinator ... --nprocs 1 --proc-id 0 --durations mas
    --batch-size 8), in a subprocess, against the one-device CLI run here
    on the same batches, draws and weights (both with deterministic
    algorithms): every loss term of every step, the MAS kernel twice per
    step and equal to the plain version on the step's neg_cent, the
    collectives of a step, ms per step. Where a term is not bit-equal, a
    second one-device run measures the card's own run-to-run floor."""
    import shutil

    import torch
    from music_generation_tpu_torch.ops import maximum_path
    from music_generation_tpu_torch.train.__main__ import main as train_main
    root = SCRATCH / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    common = ["--durations", "mas", "--batch-size", str(TRAIN_BATCH),
              "--steps", str(PARALLEL_STEPS), "--log-every", "1",
              "--warmup-steps", "0"]
    report = root / "rank0.json"
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--train-rank",
             str(report), "--", *common, "--ckpt-dir", str(root / "nccl"),
             "--multihost", "--coordinator", f"localhost:{free_port()}",
             "--nprocs", "1", "--proc-id", "0"],
            capture_output=True, text=True, timeout=600,
            cwd=Path(__file__).resolve().parent)
        wall = time.time() - t0
        if proc.returncode:
            raise AssertionError(f"the one-rank trainer exited "
                                 f"{proc.returncode}: {proc.stdout[-2000:]}"
                                 f"{proc.stderr[-3000:]}")
        for want in ("process 0/1", "mesh: {'data': 1, 'model': 1} over 1 "
                     "devices"):
            if want not in proc.stdout:
                raise AssertionError(f"no {want!r} in {proc.stdout[-2000:]}")
        rank = json.loads(report.read_text())
        launches0 = maximum_path.kernel_launches

        def one_device(tag):
            deterministic()
            try:
                train_main(common + ["--device", str(device), "--ckpt-dir",
                                     str(root / tag)])
            finally:
                deterministic(False)
            with open(root / tag / "logs" / "train_metrics.jsonl") as fh:
                return [json.loads(line) for line in fh]
        rows = {"nccl": [], "one": one_device("one")}
        one_launches = maximum_path.kernel_launches - launches0
        with open(root / "nccl" / "logs" / "train_metrics.jsonl") as fh:
            rows["nccl"] = [json.loads(line) for line in fh]
        step_files = [sorted(os.listdir(root / tag)) for tag in
                      ("nccl", "one")]
        keys = [k for k in rows["one"][0] if k.startswith("loss")]
        rel, unequal = loss_gap(rows["nccl"], rows["one"], keys)
        floor = None
        if unequal:  # the card's own run-to-run floor on one device
            floor = loss_gap(one_device("again"), rows["one"], keys)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    if step_files[0] != step_files[1] or \
            f"step_{PARALLEL_STEPS}.pt" not in step_files[0]:
        raise AssertionError(f"step files {step_files}")
    if rank["mas_launches"] != 2 * PARALLEL_STEPS or rank["mas_plain_calls"]:
        raise AssertionError(f"the one-rank trainer launched MAS "
                             f"{rank['mas_launches']} times (plain "
                             f"{rank['mas_plain_calls']}); want "
                             f"{2 * PARALLEL_STEPS} and 0")
    if one_launches != 2 * PARALLEL_STEPS:
        raise AssertionError(f"the one-device run launched MAS "
                             f"{one_launches} times")
    if len(rows["nccl"]) != PARALLEL_STEPS or rel > LOSS_REL_LIMIT:
        raise AssertionError(f"one-rank NCCL losses against one device: "
                             f"{len(rows['nccl'])} rows, max relative "
                             f"{rel:.3e} at {unequal}")
    warm = rank["step_ms"][1:-1]          # the last step ran profiled
    return {"steps": PARALLEL_STEPS, "wall_s": wall,
            "cold_ms": rank["step_ms"][0], "warm_ms": warm,
            "ms_per_step": float(np.median(warm)),
            "f32_ms_per_step_phase8": f32_row["ms_per_step"],
            "loss_terms_bit_equal": not unequal,
            "loss_terms_unequal": unequal, "loss_rel_max": rel,
            "one_device_floor": None if floor is None else {
                "loss_rel_max": floor[0], "unequal": floor[1]},
            "mas_launches": rank["mas_launches"],
            "kernel_vs_plain": rank["kernel_vs_plain"],
            "neg_cent_dtype": rank["neg_cent_dtype"],
            "collectives_step": rank["collectives_step"],
            "losses_first": {k: rows["nccl"][0][k] for k in keys}}


def serve_mesh(device) -> dict:
    """Phase 16b: serve.app's songs with --mesh 1x1 over HTTP give the WAV
    bytes of the songs without --mesh (same seed, same request); --mesh 2x1
    on this one-card machine is refused, naming the device count."""
    import io as _io

    import torch
    from music_generation_tpu_torch.serve import app
    wavs, walls = [], []
    for extra in ([], ["--mesh", "1x1"]):
        args, cfg = app.configure(["--device", str(device)] + extra)
        songs = app.build_songs(args, cfg)
        # one batched path: a 1x1 mesh, with or without --mesh, is one row
        # that runs the synthesizer's own model
        if any(len(svs.mesh) != 1 or len(svs.mesh[0]) != 1
               or svs._rows[0].model is not svs.model
               for svs in songs.synthesizers.values()):
            raise AssertionError(f"--mesh {extra}: synthesizers' meshes")
        with http_service(songs) as (_, port):
            _post(port, REQUESTS[1])               # cold
            t0 = time.time()
            out = _post(port, REQUESTS[1])
            walls.append(time.time() - t0)
        if out.get("code") != 200:
            raise AssertionError(f"--mesh {extra}: {out}")
        wavs.append(base64.b64decode(out["data"]["audio"]))
        del songs
        torch.cuda.empty_cache()
    if wavs[0] != wavs[1]:
        raise AssertionError("--mesh 1x1 sang other WAV bytes")
    err = _io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            app.configure(["--device", str(device), "--mesh", "2x1"])
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    n = torch.cuda.device_count()
    want = f"needs 2 devices; {n} available"
    if code == 0 or want not in err.getvalue():
        raise AssertionError(f"--mesh 2x1: exit {code}, {err.getvalue()}")
    return {"wav_bytes": len(wavs[0]), "equal": True,
            "warm_request_s": {"unmeshed": walls[0], "mesh_1x1": walls[1]},
            "mesh_2x1_exit": code,
            "mesh_2x1_message": err.getvalue().strip().splitlines()[-1]}


def load_tool(name: str):
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tools_on_card(device) -> dict:
    """Phase 16c: the port's offline tools on the card, on phase 14's toy
    corpus and its MAS-trained full-width step_1.pt: copy-synthesis,
    the sung song, MAS against ground truth (the same file on both
    sides: the tool's run, not a training comparison), the two-singer
    HTTP demo over the exported file (it exits non-zero: one file, two
    seeds of prior noise, no octave between them), and the e2e demo's
    trained melody served (--only e2e).
    Each writes its JSON; the headline numbers come back."""
    import shutil
    root = SCRATCH / "tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ckpt, npy, dev = str(KEPT / "step_1.pt"), str(KEPT / "npy"), str(device)
    rows = {}
    try:
        t0 = time.time()
        out = root / "copy.json"
        load_tool("torch_eval_copy_synthesis").main([
            "--ckpt", ckpt, "--data-dir", npy, "--n", "4", "--noise-scale",
            "0", "--device", dev, "--out", str(out)])
        r = json.loads(out.read_text())
        rows["eval_copy_synthesis"] = {
            k: r[k] for k in ("mel_l1_trained", "mel_l1_random_init",
                              "improvement_x", "f0_rmse_semitones_trained",
                              "rms_ratio_rec_vs_ref")} | {
            "wall_s": time.time() - t0}
        t0 = time.time()
        out = root / "sung.json"
        load_tool("torch_eval_sung_song").main([
            "--ckpt", ckpt, "--device", dev, "--out", str(out)])
        r = json.loads(out.read_text())
        rows["eval_sung_song"] = {
            k: r[k] for k in ("n_notes", "n_tracked_notes",
                              "note_rmse_semitones",
                              "frac_notes_within_half_semitone")} | {
            "wall_s": time.time() - t0}
        t0 = time.time()
        out = root / "mas_vs_gt.json"
        load_tool("torch_mas_vs_gt").main([
            "--gt-ckpt", ckpt, "--mas-ckpt", ckpt, "--data-dir", npy,
            "--device", dev, "--out", str(out)])
        r = json.loads(out.read_text())
        if r["max_mas_over_gt_ratio"] != 1.0:
            raise AssertionError(f"mas_vs_gt of one file: {r['pairs']}")
        rows["mas_vs_gt"] = {"ratio": r["max_mas_over_gt_ratio"],
                             "wall_s": time.time() - t0}
        t0 = time.time()
        load_tool("torch_export_trained_svs").main([
            "--ckpt", ckpt, "--out", str(root / "served"), "--speakers",
            "0", "1"])
        out = root / "ms.json"
        try:
            load_tool("torch_multispeaker_demo").main([
                "--checkpoint-dir", str(root / "served"), "--device", dev,
                "--port", str(free_port()), "--out", str(out),
                "--startup-timeout", "300", "--request-timeout", "300"])
        except SystemExit as e:
            if "NOT distinct" not in str(e.code):
                raise
        r = json.loads(out.read_text())
        rows["multispeaker_demo"] = {
            "voices_distinct": r["voices_distinct"],
            "bright": r["voices"]["bright"], "deep": r["voices"]["deep"],
            "wall_s": time.time() - t0}
        t0 = time.time()
        out = root / "e2e.json"
        r = load_tool("torch_e2e_trained_demo").main([
            "--only", "e2e", "--steps", "40", "--device", dev, "--out",
            str(out)])
        if json.loads(out.read_text()) != r:
            raise AssertionError("e2e JSON differs from its report")
        rows["e2e_trained_demo"] = {
            "melody_note": r["melody_note"], "duration_mse":
            r["duration_mse"], "e2e": r["e2e"], "wall_s": time.time() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(KEPT, ignore_errors=True)
    return rows


def phase_parallel_and_tools(device, f32_row: dict) -> dict:
    """Phase 16: the one-rank NCCL trainer (16a), serve --mesh (16b), the
    offline tools on the card (16c)."""
    import torch
    start = time.time()
    rows = {"trainer": parallel_trainer(device, f32_row)}
    t = rows["trainer"]
    log(f"parallel phase: one-rank NCCL trainer, {t['steps']} full-width "
        f"steps at B={TRAIN_BATCH}: warm {t['ms_per_step']:.1f} ms per step "
        f"(phase 8: {t['f32_ms_per_step_phase8']:.1f}), loss terms "
        + ("bit-equal to one device" if t["loss_terms_bit_equal"] else
           f"within {t['loss_rel_max']:.3e} of one device "
           f"({len(t['loss_terms_unequal'])} unequal; one device against "
           f"itself: {t['one_device_floor']['loss_rel_max']:.3e}, "
           f"{len(t['one_device_floor']['unequal'])} unequal)")
        + f", MAS {t['mas_launches']} launches, kernel == plain on the "
        f"step's neg_cent, collectives per step: "
        f"{t['collectives_step']['host_ops']}, NCCL device kernels "
        f"{t['collectives_step']['device_total']}")
    torch.cuda.empty_cache()
    rows["serve_mesh"] = serve_mesh(device)
    m = rows["serve_mesh"]
    log(f"parallel phase: --mesh 1x1 WAV == unmeshed ({m['wav_bytes']:,} "
        f"bytes; warm {m['warm_request_s']['mesh_1x1']:.3f} s vs "
        f"{m['warm_request_s']['unmeshed']:.3f} s), --mesh 2x1 exit "
        f"{m['mesh_2x1_exit']}: {m['mesh_2x1_message']}")
    torch.cuda.empty_cache()
    rows["tools"] = tools_on_card(device)
    log("parallel phase: tools " + json.dumps(rows["tools"],
                                              ensure_ascii=False))
    rows["phase_s"] = time.time() - start
    log(f"parallel phase: {rows['phase_s']:.1f} s")
    return rows


def main() -> int:
    import torch
    if len(sys.argv) > 3 and sys.argv[1] == "--train-rank" and \
            sys.argv[3] == "--":
        return train_rank(sys.argv[2], sys.argv[4:])
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
    train, trained = phase_train(device)
    checkpoint = phase_checkpoint(device, *trained, earlier.pop("served"))
    del trained
    torch.cuda.empty_cache()
    decoders = phase_decoders(device)
    torch.cuda.empty_cache()
    f0_variants = phase_f0_variants(device)
    torch.cuda.empty_cache()
    surface = phase_served_surface(device)
    torch.cuda.empty_cache()
    v1_model = phase_v1_model(device)
    torch.cuda.empty_cache()
    corpus_v1 = phase_corpus_and_v1(device)
    torch.cuda.empty_cache()
    seq_train = phase_seq_train(device, train)
    torch.cuda.empty_cache()
    parallel = phase_parallel_and_tools(device, train)
    record = earlier.pop("record")
    record["launches"] = (record["shapes"]["launches"]
                          + train["mas_launches"]
                          + f0_variants["train"]["mas_launches"]
                          + v1_model["train_plain"]["mas_launches"]
                          + corpus_v1["corpus"]["mas_launches"]
                          + seq_train["bf16"]["mas_launches"]
                          + parallel["trainer"]["mas_launches"])
    log(json.dumps(earlier | {"train": train, "checkpoint": checkpoint,
                              "decoders": decoders,
                              "f0_variants": f0_variants,
                              "served_surface": surface,
                              "v1_model": v1_model,
                              "corpus_and_v1": corpus_v1,
                              "seq_train": seq_train,
                              "parallel": parallel},
                   ensure_ascii=False))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
