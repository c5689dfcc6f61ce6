from . import losses
from .configs import build_svs_config, tool_shapes
from .data import BATCH_KEYS, synthetic_batch, to_device
from .trainer import (Optimizer, TrainConfig, TrainState, create_states,
                      make_train_step, restore_checkpoint, save_checkpoint)

__all__ = ["losses", "TrainConfig", "TrainState", "Optimizer",
           "create_states", "make_train_step", "save_checkpoint",
           "restore_checkpoint", "synthetic_batch", "to_device", "BATCH_KEYS",
           "build_svs_config", "tool_shapes"]
