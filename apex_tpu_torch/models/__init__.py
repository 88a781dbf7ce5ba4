from apex_tpu_torch.models.generation import generate
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                       ParallelDecoderBlock, gpt2_small_config,
                                       gpt_loss, gpt_tiny_config,
                                       lm_token_loss)

__all__ = ["GPTConfig", "GPTModel", "ParallelDecoderBlock", "generate",
           "gpt2_small_config", "gpt_loss", "gpt_tiny_config",
           "lm_token_loss"]
