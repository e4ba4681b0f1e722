"""Tensor parallelism and the training step (`voice_tts_tpu/parallel/`)."""

from voice_tts_tpu_torch.parallel.mesh import (Mesh, make_mesh, param_sharding_rules,
                                               sharding_plan)
from voice_tts_tpu_torch.parallel.tp import gathered_state, shard_gpt
from voice_tts_tpu_torch.parallel.training import gpt_loss, make_train_step

__all__ = ["Mesh", "make_mesh", "param_sharding_rules", "sharding_plan", "shard_gpt",
           "gathered_state", "gpt_loss", "make_train_step"]
