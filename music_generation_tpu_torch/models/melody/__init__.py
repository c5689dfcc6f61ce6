from .api import MelodyGenerator, handle_notes
from .beam import beam_search
from .transformer import (MelodyConfig, MelodyTransformer, MSEDurationModel,
                          causal_mask, sinusoidal_position_encoding)
from .vocab import (BOS_ID, EOS_ID, PAD_ID, UNK_ID, MelodyDictionary,
                    lyric_dictionary_from_chars, note_dictionary)

__all__ = [
    "MelodyGenerator", "handle_notes", "beam_search", "MelodyConfig",
    "MelodyTransformer", "MSEDurationModel", "causal_mask",
    "sinusoidal_position_encoding", "MelodyDictionary", "note_dictionary",
    "lyric_dictionary_from_chars", "PAD_ID", "UNK_ID", "BOS_ID", "EOS_ID",
]
