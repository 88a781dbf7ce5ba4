from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
