from .checkpoints import (load_params, load_pipeline, save_params,
                          save_pipeline)
from .from_jax import (gpt2_state_dict_from_flax, melody_state_dicts_from_flax,
                       mpd_state_dict_from_flax, sdp_state_dict_from_flax,
                       seq2seq_state_dict_from_flax, state_dict_from_flax,
                       t5_state_dict_from_flax,
                       telemelody_state_dicts_from_flax,
                       visinger_state_dict_from_flax)
from .torch_import import visinger_state_dict_from_torch

__all__ = ["visinger_state_dict_from_flax", "melody_state_dicts_from_flax",
           "mpd_state_dict_from_flax", "state_dict_from_flax",
           "t5_state_dict_from_flax", "gpt2_state_dict_from_flax",
           "sdp_state_dict_from_flax", "seq2seq_state_dict_from_flax",
           "telemelody_state_dicts_from_flax",
           "visinger_state_dict_from_torch", "save_params", "load_params",
           "save_pipeline", "load_pipeline"]
