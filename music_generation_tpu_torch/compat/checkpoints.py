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
reference's ``.pth`` files.
"""

from __future__ import annotations

import logging
import os

import torch
from torch import nn

logger = logging.getLogger("music_generation_tpu_torch")


def save_params(path: str, module: nn.Module) -> None:
    """Write ``module``'s state_dict to ``path``, every tensor on the CPU
    (the file loads on any device)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def load_params(path: str, module: nn.Module) -> None:
    """Restore ``module`` in place from a save_params file, with the
    reference's tolerant contract (VISinger/utils.py load_checkpoint): a
    tensor is taken from the file where the file has it with the same
    shape, and kept at its init otherwise. When the keys and shapes match
    exactly the load is strict; otherwise one WARNING line gives the counts
    restored, kept at init and unused in the file."""
    saved = torch.load(path, map_location=_device_of(module),
                       weights_only=True)
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


def load_pipeline(ckpt_dir: str, song_synthesizer) -> list:
    """Restore the components in place; missing files are skipped (a
    missing directory raises). Returns the files loaded."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint dir {ckpt_dir} does not exist")
    parts = [(f"svs_{sid}.pt", svs.model)
             for sid, svs in song_synthesizer.synthesizers.items()]
    parts += zip(_MELODY_FILES, _melody_models(song_synthesizer.melody))
    loaded = []
    for name, model in parts:
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            load_params(p, model)
            loaded.append(name)
    if not loaded:
        logger.warning("no checkpoint file in %s: every model keeps its "
                       "construction weights", ckpt_dir)
    return loaded
