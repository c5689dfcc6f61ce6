"""Shell-pipeline backend: request -> REQ-NNNNN dir -> lyrics -> LRC -> song.

Twin of music_generation_tpu/pipeline/shell_backend.py (host code: the same
files for the same request), itself the Python-native equivalent of
lyric2lrc/music_pipeline (pipeline.sh, gen_lyrics_ollama.sh,
gen_diffrhythm_runner.sh): numbered request directories with request.json /
lyrics.txt / rough.lrc / final.lrc / song.wav and a `latest` pointer (a
copy of the three result files where a symlink cannot be made). External
engines are optional:
  - lyrics: `ollama run $MODEL` when `ollama` is on PATH, else the
    in-process lyric model (``lyric_fn``; serve.app passes the lyric LM's
    generate, which runs on the server's device), else a 4-line template;
  - audio: DiffRhythm via $DIFFRHYTHM_REPO/infer/infer.py when configured,
    else a silent 44.1 kHz WAV of at most 1 s. That silent WAV is the
    reference's documented fake backend (music_pipeline's fallback that
    keeps the chain verifiable without the external model), not a device
    fallback: this module's own work is host file and process handling.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..audio.wav import write_wav
from .lrc import LrcParams, lyrics_to_lrc, normalize_lrc

DEFAULT_MODEL = "qwen2.5:1.5b-instruct"


def ollama_prompt(request: dict) -> str:
    theme = request.get("theme", request.get("keyword", ""))
    emotion = request.get("emotion", "")
    style = request.get("style", "现代流行")
    lines = request.get("lines", 6)
    constraints = request.get(
        "constraints", "尽量押韵；不要编号或引号；不要解释；每行一条。")
    return (f"请只输出中文歌词正文（每行一句，不要编号、不要引号、不要解释）。\n"
            f"主题：{theme}\n情绪：{emotion}\n风格：{style}\n"
            f"行数建议：{lines}\n{constraints}")


def template_lyrics(theme: str) -> list[str]:
    """The reference's inline 4-line fallback
    (controllers_music_generation/syn_music.py:96-106)."""
    theme = (theme or "").strip() or "歌"
    return [f"{theme}在夜色里慢慢发光", "沿着河岸把心事流淌",
            "风把故事吹成了月光", f"我把{theme}唱进你的心房"]


@dataclass
class ShellPipelineBackend:
    root: str = "./music_pipeline_data"
    lyric_fn: Optional[Callable[[str], str]] = None  # keyword -> lyrics text
    ollama_model: str = field(
        default_factory=lambda: os.environ.get("MODEL", DEFAULT_MODEL))
    diffrhythm_repo: Optional[str] = field(
        default_factory=lambda: os.environ.get("DIFFRHYTHM_REPO"))
    sample_rate: int = 44100  # DiffRhythm output rate

    # --- request dir management (pipeline.sh:18-40) -----------------------
    def _next_request_dir(self) -> Path:
        req_root = Path(self.root) / "requests"
        req_root.mkdir(parents=True, exist_ok=True)
        ids = [int(m.group(1)) for d in req_root.iterdir() if d.is_dir()
               for m in [re.match(r"REQ-(\d{5})$", d.name)] if m]
        run_dir = req_root / f"REQ-{(max(ids) + 1 if ids else 1):05d}"
        run_dir.mkdir()
        return run_dir

    # --- lyrics (gen_lyrics_ollama.sh) -------------------------------------
    def _generate_lyrics(self, request: dict) -> list[str]:
        if request.get("raw_lyrics"):
            return [ln for ln in str(request["raw_lyrics"]).splitlines()
                    if ln.strip()]
        theme = request.get("theme", request.get("keyword", ""))
        if shutil.which("ollama"):
            try:
                out = subprocess.run(
                    ["ollama", "run", self.ollama_model, ollama_prompt(request)],
                    capture_output=True, timeout=300, check=True)
                lines = [ln for ln in out.stdout.decode().splitlines()
                         if ln.strip()]
                if lines:
                    return lines
            except Exception:
                pass
        if self.lyric_fn is not None:
            text = self.lyric_fn(theme)
            lines = [seg for seg in re.split(r"[。\n]+", text) if seg.strip()]
            if lines:
                return lines
        return template_lyrics(theme)

    # --- audio (gen_diffrhythm_runner.sh) -----------------------------------
    def _render_audio(self, run_dir: Path, request: dict) -> Path:
        wav_path = run_dir / "song.wav"
        audio_length = int(request.get("audio_length", 95) or 95)
        if self.diffrhythm_repo and os.path.isdir(self.diffrhythm_repo):
            out_dir = run_dir / "diffrhythm_output"
            out_dir.mkdir(exist_ok=True)
            cmd = [
                os.environ.get("PY", "python3"), "infer/infer.py",
                "--lrc-path", str(run_dir / "final.lrc"),
                "--ref-prompt", str(request.get("ref_prompt",
                                                "hopeful,ballad,pop,emotion")),
                "--audio-length", str(audio_length),
                "--repo-id", os.environ.get("REPO_ID", "ASLP-lab/DiffRhythm-1_2"),
                "--output-dir", str(out_dir), "--chunked",
                "--batch-infer-num", os.environ.get("BATCH_INFER_NUM", "5"),
            ]
            try:
                subprocess.run(cmd, cwd=self.diffrhythm_repo, check=True,
                               timeout=900)
                wavs = sorted(out_dir.glob("*.wav"),
                              key=lambda p: p.stat().st_mtime)
                if wavs:
                    shutil.copy(wavs[-1], wav_path)
                    return wav_path
            except Exception:
                pass
        # Fallback: silent WAV so the chain stays verifiable without the
        # external model (parity with music_pipeline's documented fallback).
        write_wav(str(wav_path),
                  np.zeros(self.sample_rate * min(audio_length, 1)),
                  self.sample_rate)
        return wav_path

    # --- orchestration (pipeline.sh main flow) ------------------------------
    def run(self, request: dict) -> dict:
        run_dir = self._next_request_dir()
        (run_dir / "request.json").write_text(
            json.dumps(request, ensure_ascii=False), encoding="utf-8")

        lines = self._generate_lyrics(request)
        (run_dir / "lyrics.txt").write_text("\n".join(lines) + "\n",
                                            encoding="utf-8")
        rough = lyrics_to_lrc(lines, LrcParams())
        (run_dir / "rough.lrc").write_text(rough, encoding="utf-8")
        final = normalize_lrc(rough)
        (run_dir / "final.lrc").write_text(final, encoding="utf-8")

        wav_path = self._render_audio(run_dir, request)

        latest = Path(self.root) / "latest"
        try:
            if latest.is_symlink() or latest.exists():
                latest.unlink() if latest.is_symlink() else shutil.rmtree(latest)
            latest.symlink_to(run_dir)
        except OSError:
            latest.mkdir(parents=True, exist_ok=True)
            for name in ("lyrics.txt", "final.lrc", "song.wav"):
                if (run_dir / name).exists():
                    shutil.copy(run_dir / name, latest / name)

        return {
            "request_id": run_dir.name,
            "lyrics_txt": str(run_dir / "lyrics.txt"),
            "final_lrc": str(run_dir / "final.lrc"),
            "audio_path": str(wav_path),
            "lyrics": "\n".join(lines),
            "lrc": final,
        }
