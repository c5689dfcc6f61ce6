from .api import MelodyGenerator, handle_durations, handle_notes
from .beam import beam_search, sample_decode
from .seq2seq import Lang, Seq2SeqConfig, Seq2SeqModel, beam_decode
from .seq2seq_api import Seq2SeqMelodyGenerator, default_langs
from .telemelody import (TeleMelodyGenerator, TeleMelodyResult, adapt,
                         adapt_e, process_lyrics)
from .transformer import (MelodyConfig, MelodyTransformer, MSEDurationModel,
                          PostNormEncoder, SDPDurationConfig,
                          SDPDurationModel, causal_mask,
                          sinusoidal_position_encoding)
from .vocab import (BOS_ID, EOS_ID, PAD_ID, UNK_ID, MelodyDictionary,
                    lyric_dictionary_from_chars, note_dictionary)

__all__ = [
    "MelodyGenerator", "handle_durations", "handle_notes", "beam_search",
    "MelodyConfig", "MelodyTransformer", "MSEDurationModel",
    "SDPDurationConfig", "SDPDurationModel", "PostNormEncoder", "causal_mask",
    "sinusoidal_position_encoding", "MelodyDictionary", "note_dictionary",
    "lyric_dictionary_from_chars", "PAD_ID", "UNK_ID", "BOS_ID", "EOS_ID",
    "Lang", "Seq2SeqConfig", "Seq2SeqModel", "beam_decode",
    "Seq2SeqMelodyGenerator", "default_langs", "sample_decode",
    "TeleMelodyGenerator", "TeleMelodyResult", "adapt", "adapt_e",
    "process_lyrics",
]
