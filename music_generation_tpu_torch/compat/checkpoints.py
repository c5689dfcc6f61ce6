"""Checkpoints of the serving pipeline: one ``torch.save`` state_dict per
component.

Twin of music_generation_tpu/compat/checkpoints.py. A pipeline directory
holds ``svs_<id>.pt`` for each singer and, when the melody generator is
the transformer family (MSE or SDP durations), ``melody_notes.pt`` and
``melody_duration.pt``. The seq2seq melody family (``melody_v2``) and the
lyric LMs are not saved or loaded, exactly as in the JAX package: they
keep their construction weights. ``tools/torch_export_trained_svs.py``
writes such a directory from the port trainer's ``step_<n>.pt``, and
``tools/torch_import_pipeline.py`` from a JAX pipeline directory or the
reference's ``.pth`` files. An ``svs_<id>.pt`` of the other VISinger variant
than the singer's model (with or without the AE spec decoder) rebuilds that
singer's model as the file's variant before the load (one WARNING): the
server serves the plain VISinger from its files alone.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
from torch import nn

from ..models.svs import VISinger

logger = logging.getLogger("music_generation_tpu_torch")


def save_params(path: str, module: nn.Module) -> None:
    """Write ``module``'s state_dict to ``path``, every tensor on the CPU
    (the file loads on any device)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _read(path: str, module: nn.Module) -> dict:
    return torch.load(path, map_location=_device_of(module),
                      weights_only=True)


def load_params(path: str, module: nn.Module,
                saved: dict | None = None) -> None:
    """Restore ``module`` in place from a save_params file (``saved``: its
    contents, when already read), with the reference's tolerant contract
    (VISinger/utils.py load_checkpoint): a tensor is taken from the file
    where the file has it with the same shape, and kept at its init
    otherwise. When the keys and shapes match exactly the load is strict;
    otherwise one WARNING line gives the counts restored, kept at init and
    unused in the file."""
    if saved is None:
        saved = _read(path, module)
    target = module.state_dict()
    if saved.keys() == target.keys() and all(
            saved[k].shape == v.shape for k, v in target.items()):
        module.load_state_dict(saved, strict=True)
        return
    merged = {k: saved[k] for k, v in target.items()
              if k in saved and saved[k].shape == v.shape}
    module.load_state_dict(merged, strict=False)
    logger.warning(
        "tolerant restore from %s: %d tensors restored, %d kept at init, "
        "%d in the file unused", path, len(merged),
        len(target) - len(merged), len(saved) - len(merged))


def _melody_models(melody) -> tuple:
    """The transformer melody's (note model, duration model), or () for a
    family that is not loaded (the JAX ``hasattr(melody, "note_params")``
    test)."""
    if hasattr(melody, "note_model") and hasattr(melody, "duration_model"):
        return melody.note_model, melody.duration_model
    return ()


_MELODY_FILES = ("melody_notes.pt", "melody_duration.pt")


def save_pipeline(ckpt_dir: str, song_synthesizer) -> None:
    """Persist every loadable component of a SongSynthesizer."""
    for sid, svs in song_synthesizer.synthesizers.items():
        save_params(os.path.join(ckpt_dir, f"svs_{sid}.pt"), svs.model)
    for name, model in zip(_MELODY_FILES,
                           _melody_models(song_synthesizer.melody)):
        save_params(os.path.join(ckpt_dir, name), model)


def _match_svs_variant(path: str, svs, saved: dict) -> None:
    """Rebuild ``svs.model`` as the file's VISinger variant when the file
    holds the other one: the AE variant's files have spec_decoder
    tensors, the plain variant's have none."""
    autoencoder = any(k.startswith("spec_decoder.") for k in saved)
    if autoencoder == svs.cfg.autoencoder:
        return
    logger.warning("%s holds the %s VISinger: singer rebuilt with "
                   "autoencoder=%s", path, "AE" if autoencoder else "plain",
                   autoencoder)
    device = _device_of(svs.model)
    svs.cfg = dataclasses.replace(svs.cfg, autoencoder=autoencoder)
    with torch.random.fork_rng(devices=[]):  # its init is overwritten
        svs.model = VISinger(svs.cfg).to(device).eval()


def load_pipeline(ckpt_dir: str, song_synthesizer) -> list:
    """Restore the components in place; missing files are skipped (a
    missing directory raises). A singer's file of the other VISinger
    variant rebuilds that singer first (_match_svs_variant). Returns the
    files loaded."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint dir {ckpt_dir} does not exist")
    loaded = []
    for sid, svs in song_synthesizer.synthesizers.items():
        p = os.path.join(ckpt_dir, f"svs_{sid}.pt")
        if os.path.exists(p):
            saved = _read(p, svs.model)
            _match_svs_variant(p, svs, saved)
            load_params(p, svs.model, saved)
            loaded.append(f"svs_{sid}.pt")
    for name, model in zip(_MELODY_FILES,
                           _melody_models(song_synthesizer.melody)):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            load_params(p, model)
            loaded.append(name)
    if not loaded:
        logger.warning("no checkpoint file in %s: every model keeps its "
                       "construction weights", ckpt_dir)
    return loaded
