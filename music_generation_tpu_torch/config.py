"""Unified configuration tree (replaces the reference's four mechanisms:
config.py root_path, YAML EasyDict server configs, JSON HParams, env-var
flags — SURVEY.md §5)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class ServiceConfig:
    host: str = "0.0.0.0"
    port: int = 5005
    log_dir: str = "./logs"
    log_name: str = "music_generation_tpu_torch"
    # "model" = in-process lyric->melody->SVS; "shell" = the ollama/
    # DiffRhythm pipeline (pipeline/shell_backend.py; MUSIC_BACKEND=new or
    # --variant v1) in front of the model path, which answers when it fails
    backend: str = "model"
    n_speakers: int = 3
    tiny: bool = False           # tiny random models (CI / smoke)
    max_text_len: int = 500
    min_text_len: int = 1
    checkpoint_dir: Optional[str] = None
    # cross-request SVS micro-batching (serve/batching.py): concurrent
    # requests' sentences coalesce into one device call. window_ms=0 batches
    # naturally (arrivals during an in-flight call join the next one).
    svs_batching: bool = True
    batch_window_ms: float = 0.0
    # largest SVS batch per device call: inherited; not yet measured on the
    # H100
    max_batch_sentences: int = 16
    # server_configs/config_music_generation.yaml:12: a PEM certificate
    # makes serve.app terminate TLS (--cert-file overrides it)
    cert_file_path: Optional[str] = None

    @classmethod
    def from_file(cls, path: str) -> "ServiceConfig":
        with open(path, encoding="utf-8") as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                raw = yaml.safe_load(f)
            else:
                raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    @classmethod
    def from_env(cls, base: Optional["ServiceConfig"] = None) -> "ServiceConfig":
        """Environment overrides (parity with the reference's env flags)."""
        cfg = base or cls()
        if os.environ.get("MUSIC_BACKEND") == "new":
            cfg.backend = "shell"
        elif os.environ.get("MUSIC_BACKEND") == "old":
            cfg.backend = "model"
        if "MUSIC_PORT" in os.environ:
            cfg.port = int(os.environ["MUSIC_PORT"])
        return cfg
