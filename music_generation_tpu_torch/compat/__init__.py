from .from_jax import (gpt2_state_dict_from_flax, melody_state_dicts_from_flax,
                       mpd_state_dict_from_flax, state_dict_from_flax,
                       t5_state_dict_from_flax, visinger_state_dict_from_flax)

__all__ = ["visinger_state_dict_from_flax", "melody_state_dicts_from_flax",
           "mpd_state_dict_from_flax", "state_dict_from_flax",
           "t5_state_dict_from_flax", "gpt2_state_dict_from_flax"]
