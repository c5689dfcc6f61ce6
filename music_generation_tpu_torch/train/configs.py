"""CLI -> SVSConfig construction for the trainer.

Twin of music_generation_tpu/train/configs.py. The port trains the default
configuration only; the other decoders, NSF excitation and the residual F0
head raise NotImplementedError until they are ported.
"""

from __future__ import annotations

from ..models.svs import SVSConfig

#: decoder choices of the JAX trainer; only "hifigan" is ported
DECODERS = ("hifigan", "istft", "mb_istft")


def build_svs_config(tiny: bool = False, decoder: str = "hifigan",
                     nsf: bool = False,
                     f0_residual: bool = False) -> SVSConfig:
    """One SVSConfig for the trainer; raises on invalid combinations and on
    options not yet ported."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder != "hifigan":
        raise NotImplementedError(f"--decoder {decoder} is not yet ported")
    if nsf:
        raise NotImplementedError("--nsf is not yet ported")
    if f0_residual:
        raise NotImplementedError("--f0-residual is not yet ported")
    if tiny:
        return SVSConfig(
            inter_channels=16, hidden_channels=16, filter_channels=32,
            n_heads=2, n_layers=1, spec_channels=65,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            upsample_rates=(4, 4), upsample_initial_channel=32,
            upsample_kernel_sizes=(8, 8), segment_size=16 * 8, hop_length=16)
    return SVSConfig()


def tool_shapes(tiny: bool) -> tuple[int, int]:
    """(t_phones, t_frames) the trainer pads batches to."""
    return (8, 32) if tiny else (64, 480)
