from .synthesis import (SongResult, SongSynthesizer, SVSSynthesizer,
                        build_default_song_synthesizer, split_sentences)

__all__ = ["SVSSynthesizer", "SongSynthesizer", "SongResult",
           "build_default_song_synthesizer", "split_sentences"]
