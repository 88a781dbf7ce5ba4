from apex_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                        BertLayer, BertSelfAttention,
                                        bert_large_config,
                                        bert_pretrain_loss,
                                        bert_pretrain_loss_fn,
                                        bert_tiny_config, synthetic_batch)
from apex_tpu_torch.models.generation import (generate, generate_beam,
                                              speculative_generate)
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                       ParallelDecoderBlock, gpt2_small_config,
                                       gpt_loss, gpt_tiny_config,
                                       lm_token_loss)
from apex_tpu_torch.models.llama import (LlamaConfig, LlamaDecoderBlock,
                                         LlamaModel, llama_loss,
                                         llama_tiny_config,
                                         mistral_7b_config)
from apex_tpu_torch.models.quantize import (WeightPrecisionPolicy,
                                            assert_quantized_loaded,
                                            quantize_model_params,
                                            quantize_params_like)
from apex_tpu_torch.models.t5 import (T5Config, T5DecoderBlock,
                                      T5EncoderBlock, T5Model,
                                      T5RelativeBias,
                                      relative_position_bucket,
                                      t5_beam_search, t5_generate,
                                      t5_loss, t5_tiny_config)

__all__ = ["BertConfig", "BertForPreTraining", "BertLayer",
           "BertSelfAttention", "GPTConfig", "GPTModel", "LlamaConfig",
           "LlamaDecoderBlock", "LlamaModel", "ParallelDecoderBlock",
           "WeightPrecisionPolicy",
           "assert_quantized_loaded", "bert_large_config",
           "bert_pretrain_loss",
           "bert_pretrain_loss_fn", "bert_tiny_config", "generate",
           "generate_beam",
           "gpt2_small_config", "gpt_loss", "gpt_tiny_config",
           "llama_loss", "llama_tiny_config", "lm_token_loss",
           "mistral_7b_config",
           "quantize_model_params", "quantize_params_like",
           "speculative_generate", "synthetic_batch", "T5Config",
           "T5DecoderBlock", "T5EncoderBlock", "T5Model", "T5RelativeBias",
           "relative_position_bucket", "t5_beam_search", "t5_generate",
           "t5_loss",
           "t5_tiny_config"]
