from .midi import Note, Track, seconds_to_ticks, write_midi, write_midi_bytes
from .stft import (hann_window, mel_filterbank, mel_spectrogram, spec_to_mel,
                   spectrogram)
from .wav import (SAMPLE_RATE, concat_with_delay, mix, normalize_int16,
                  read_wav, resample, streaming_wav_header, write_wav,
                  write_wav_bytes)

__all__ = ["Note", "Track", "write_midi", "write_midi_bytes",
           "seconds_to_ticks", "spectrogram", "spec_to_mel",
           "mel_spectrogram", "mel_filterbank", "hann_window",
           "SAMPLE_RATE", "concat_with_delay", "mix", "normalize_int16",
           "read_wav", "resample", "streaming_wav_header", "write_wav",
           "write_wav_bytes"]
