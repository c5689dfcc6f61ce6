from .wav import (SAMPLE_RATE, concat_with_delay, normalize_int16,
                  streaming_wav_header, write_wav_bytes)

__all__ = ["SAMPLE_RATE", "concat_with_delay", "normalize_int16",
           "streaming_wav_header", "write_wav_bytes"]
