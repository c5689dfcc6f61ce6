"""CLI -> SVSConfig construction for the trainer.

Twin of music_generation_tpu/train/configs.py: the trainer and the
export and import tools build the same SVSConfig from (tiny, decoder, nsf,
f0_residual). NSF excitation is wired into the HiFi-GAN decoder only.
"""

from __future__ import annotations

import dataclasses

from ..models.svs import SVSConfig

#: decoder choices of the trainer and the server
DECODERS = ("hifigan", "istft", "mb_istft")


def build_svs_config(tiny: bool = False, decoder: str = "hifigan",
                     nsf: bool = False,
                     f0_residual: bool = False) -> SVSConfig:
    """One SVSConfig for the trainer and the tools; raises ValueError on an
    invalid combination."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if nsf and decoder != "hifigan":
        raise ValueError("--nsf requires --decoder hifigan (NSF excitation "
                         "is wired into the HiFi-GAN upsample stack only)")
    if not tiny:
        return SVSConfig(decoder_type=decoder, nsf=nsf,
                         f0_residual=f0_residual)
    cfg = SVSConfig(
        inter_channels=16, hidden_channels=16, filter_channels=32,
        n_heads=2, n_layers=1, spec_channels=65,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        upsample_rates=(4, 4), upsample_initial_channel=32,
        upsample_kernel_sizes=(8, 8), segment_size=16 * 8, hop_length=16,
        decoder_type=decoder, nsf=nsf, f0_residual=f0_residual)
    # tiny hop 16: istft 4 * 4; mb_istft 2 * 4 * 2
    if decoder == "istft":
        return dataclasses.replace(cfg, istft_upsample_rates=(4,),
                                   istft_upsample_kernel_sizes=(8,))
    if decoder == "mb_istft":
        return dataclasses.replace(cfg, mb_upsample_rates=(2,),
                                   mb_upsample_kernel_sizes=(4,),
                                   mb_subbands=2)
    return cfg


def tool_shapes(tiny: bool) -> tuple[int, int]:
    """(t_phones, t_frames) the trainer pads batches to."""
    return (8, 32) if tiny else (64, 480)
