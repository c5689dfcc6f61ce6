"""Seeds and weights made from ``--seed``.

The weights are the reference modules' own initialisation, run on the
device: each module is built with the device as the default, so every
initialiser draws from the device's generator, seeded from the run's seed
and the module's tag. The same seed and tag give the same weights, so the
reference builds them again after the window instead of keeping a copy,
and the program is handed them by ``load_state_dict``.
"""

from __future__ import annotations

import contextlib
import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@contextlib.contextmanager
def seeded_on(device, seed: int, tag: str):
    """Build modules inside this block on ``device``, with every draw of
    their initialisers from the generator seeded by (seed, tag); the
    process's generators are left as they were."""
    device = torch.device(device)
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        s = sub_seed(seed, tag)
        torch.manual_seed(s)
        if device.type == "cuda":
            torch.cuda.manual_seed(s)
        with device:
            yield


def build(factory, device, seed: int, tag: str) -> torch.nn.Module:
    """``factory()`` built on ``device`` from (seed, tag), in eval mode."""
    with seeded_on(device, seed, tag):
        module = factory()
    return module.to(device).eval()


def hand_over(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Copy ``src``'s parameters and buffers into the program's module
    ``dst`` (same names, same shapes, every one of them)."""
    dst.load_state_dict(src.state_dict(), strict=True)


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, tag))
