#!/usr/bin/env python3
"""Two-voice multispeaker proof through the port's served HTTP path.

Twin of tools/multispeaker_demo.py: spawns ``python -m
music_generation_tpu_torch.serve.app --checkpoint-dir <dir>`` (svs_0 the
"bright" voice, svs_1 the "deep" one, as tools/torch_export_trained_svs.py
writes them), POSTs /synthesis_music with the same lyrics for singer 0 and
singer 1, measures each returned WAV's median YIN F0 and spectral centroid,
and judges whether the voices differ as the toy corpus' voices do (deep
about an octave below, its centroid well under bright's). Same flags and
JSON keys as the JAX tool, plus ``--device`` (the server's, default
cuda); the JSON and the WAVs are written only where ``--out`` and
``--wav-prefix`` say. Exits non-zero, after writing, when the voices are
not distinct.

Usage:
  python tools/torch_multispeaker_demo.py --checkpoint-dir served_ms \
      [--nsf] [--f0-residual] [--tiny] [--port 5113] \
      [--text 你好世界天地人和] \
      [--out artifacts/torch_multispeaker_demo.json] \
      [--wav-prefix artifacts/torch_multispeaker] [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def wait_healthz(port: int, timeout_s: float, proc) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited rc={proc.returncode}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"server not healthy after {timeout_s}s")


def synthesize(port: int, text: str, singer_id: int,
               timeout_s: float) -> bytes:
    body = json.dumps({"text": text, "singer_id": singer_id}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesis_music", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        resp = json.loads(r.read())
    if resp.get("code") != 200:
        raise RuntimeError(f"singer {singer_id}: {resp}")
    return base64.b64decode(resp["data"]["audio"])


def voice_stats(wav_bytes: bytes) -> dict:
    """Length, median YIN F0 (hop 256), spectral centroid and RMS of an
    int16 WAV, as the JAX tool measures them."""
    import numpy as np
    from scipy.io import wavfile

    from music_generation_tpu_torch.audio.f0 import yin_f0

    sr, wav = wavfile.read(io.BytesIO(wav_bytes))
    x = wav.astype(np.float32) / 32768.0
    f0 = yin_f0(x, sample_rate=sr, hop=256)
    voiced = f0[f0 > 0]
    mag = np.abs(np.fft.rfft(x))
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    return {
        "audio_s": round(len(x) / sr, 2),
        "median_f0_hz": round(float(np.median(voiced)), 1) if len(voiced)
        else None,
        "spectral_centroid_hz": round(float((mag * freqs).sum()
                                            / max(mag.sum(), 1e-9)), 1),
        "rms": round(float(np.sqrt((x ** 2).mean())), 4),
    }


def verdict(bright: dict, deep: dict) -> dict:
    """The register gap in semitones, the centroid ratio and whether the
    voices differ as the training data does (a 9-15 semitone gap and a
    deep/bright centroid ratio under 0.75)."""
    import numpy as np
    gap = (12.0 * np.log2(bright["median_f0_hz"] / deep["median_f0_hz"])
           if bright["median_f0_hz"] and deep["median_f0_hz"] else None)
    ratio = round(deep["spectral_centroid_hz"]
                  / max(bright["spectral_centroid_hz"], 1e-9), 3)
    return {"register_gap_semitones": (round(float(gap), 2)
                                       if gap is not None else None),
            "centroid_ratio_deep_over_bright": ratio,
            "voices_distinct": bool(gap is not None and 9.0 <= gap <= 15.0
                                    and ratio < 0.75)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", required=True,
                   help="pipeline directory with svs_0 (bright) and svs_1 "
                        "(deep) from tools/torch_export_trained_svs.py")
    p.add_argument("--port", type=int, default=5113)
    p.add_argument("--text", default="你好世界天地人和",
                   help="lyrics (toy-lexicon characters; both voices sing "
                        "the same melody)")
    p.add_argument("--nsf", action="store_true")
    p.add_argument("--f0-residual", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--wav-prefix", default=None)
    p.add_argument("--startup-timeout", type=float, default=1800.0)
    p.add_argument("--request-timeout", type=float, default=1800.0)
    p.add_argument("--provenance", default=None,
                   help="JSON string recording how the two checkpoints "
                        "were trained (stored verbatim in the result)")
    p.add_argument("--device", default="cuda",
                   help="the server's torch device")
    args = p.parse_args(argv)

    cmd = [sys.executable, "-m", "music_generation_tpu_torch.serve.app",
           "--port", str(args.port), "--checkpoint-dir", args.checkpoint_dir,
           "--device", args.device]
    for flag in ("nsf", "f0_residual", "tiny"):
        if getattr(args, flag):
            cmd.append("--" + flag.replace("_", "-"))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env)
    try:
        wait_healthz(args.port, args.startup_timeout, proc)
        result = {"text": args.text, "checkpoint_dir": args.checkpoint_dir,
                  "voices": {}}
        for sid, name in ((0, "bright"), (1, "deep")):
            wav = synthesize(args.port, args.text, sid, args.request_timeout)
            stats = voice_stats(wav)
            if args.wav_prefix:
                stats["wav"] = f"{args.wav_prefix}_{name}.wav"
                os.makedirs(os.path.dirname(stats["wav"]) or ".",
                            exist_ok=True)
                with open(stats["wav"], "wb") as f:
                    f.write(wav)
            result["voices"][name] = stats
            print(f"singer {sid} ({name}): {stats}", flush=True)
        result.update(verdict(result["voices"]["bright"],
                              result["voices"]["deep"]))
        if args.provenance:
            result["provenance"] = json.loads(args.provenance)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1, ensure_ascii=False)
                f.write("\n")
        print(json.dumps({k: v for k, v in result.items() if k != "voices"},
                         ensure_ascii=False))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    if not result["voices_distinct"]:
        sys.exit("voices are NOT distinct" + (f" — see {args.out}"
                                              if args.out else ""))
    return result


if __name__ == "__main__":
    main()
