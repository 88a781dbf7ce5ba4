"""Data-parallel utilities of the port (counterpart of
``apex_tpu.parallel``): ``SyncBatchNorm``, ``convert_syncbn_model`` and the
``DistributedDataParallel`` facade, on one rank. Across ranks they raise
(ROADMAP queue A item 10); ``LARC`` waits (ROADMAP queue A item 12)."""

from apex_tpu_torch.parallel.distributed import DistributedDataParallel
from apex_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                    convert_syncbn_model,
                                                    sync_batch_norm_stats)

__all__ = ["DistributedDataParallel", "SyncBatchNorm", "convert_syncbn_model",
           "sync_batch_norm_stats"]
