from .hifigan import (DiscriminatorP, DiscriminatorS, Generator,
                      MultiPeriodDiscriminator, ResBlock1, ResBlock2)
from .visinger import (SVSConfig, PosteriorEncoder, SpecDecoder, TextEncoder,
                       TextPostNet, VISinger, f0_to_coarse, note_hz_frames)

__all__ = ["Generator", "ResBlock1", "ResBlock2", "DiscriminatorP",
           "DiscriminatorS", "MultiPeriodDiscriminator", "SVSConfig",
           "VISinger", "TextEncoder", "TextPostNet", "PosteriorEncoder",
           "SpecDecoder", "f0_to_coarse", "note_hz_frames"]
