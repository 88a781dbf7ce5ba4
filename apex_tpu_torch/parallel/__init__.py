"""Data-parallel utilities of the port (counterpart of
``apex_tpu.parallel``): ``SyncBatchNorm``, ``convert_syncbn_model`` and
``DistributedDataParallel`` over a ``torch.distributed`` group (the
installed data-parallel group by default), ``run_ranks`` (``spawn``) to
start ranks and ``init_ranks`` to join them under ``torchrun``; ``LARC`` waits (ROADMAP queue A item 12)."""

from apex_tpu_torch.parallel.distributed import (DistributedDataParallel,
                                                 data_parallel_group)
from apex_tpu_torch.parallel.spawn import init_ranks, run_ranks
from apex_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                    convert_syncbn_model,
                                                    sync_batch_norm_stats)

__all__ = ["DistributedDataParallel", "SyncBatchNorm", "convert_syncbn_model",
           "data_parallel_group", "init_ranks", "run_ranks",
           "sync_batch_norm_stats"]
