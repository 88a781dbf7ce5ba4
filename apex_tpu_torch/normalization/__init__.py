from apex_tpu_torch.normalization.fused_layer_norm import (FusedLayerNorm,
                                                           FusedRMSNorm)

__all__ = ["FusedLayerNorm", "FusedRMSNorm"]
