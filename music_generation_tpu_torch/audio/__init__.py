from .wav import (SAMPLE_RATE, concat_with_delay, mix, normalize_int16,
                  read_wav, resample, streaming_wav_header, write_wav,
                  write_wav_bytes)

__all__ = ["SAMPLE_RATE", "concat_with_delay", "mix", "normalize_int16",
           "read_wav", "resample", "streaming_wav_header", "write_wav",
           "write_wav_bytes"]
