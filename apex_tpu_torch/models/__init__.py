from apex_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                        BertLayer, BertSelfAttention,
                                        bert_large_config,
                                        bert_pretrain_loss,
                                        bert_pretrain_loss_fn,
                                        bert_tiny_config, synthetic_batch)
from apex_tpu_torch.models.generation import generate
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                       ParallelDecoderBlock, gpt2_small_config,
                                       gpt_loss, gpt_tiny_config,
                                       lm_token_loss)

__all__ = ["BertConfig", "BertForPreTraining", "BertLayer",
           "BertSelfAttention", "GPTConfig", "GPTModel",
           "ParallelDecoderBlock", "bert_large_config", "bert_pretrain_loss",
           "bert_pretrain_loss_fn", "bert_tiny_config", "generate",
           "gpt2_small_config", "gpt_loss", "gpt_tiny_config",
           "lm_token_loss", "synthetic_batch"]
