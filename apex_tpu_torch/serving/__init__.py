"""Paged-KV continuous-batching serving on one GPU, or over tensor-parallel
ranks (``TensorParallelPagedEngine``): greedy and sampled
decode over a full-precision or quantized page pool, the shared-prefix
cache, in-engine speculative decode and chunked prefill, driven by the
streaming :class:`ServingFrontend` (priorities, deadlines, preemption,
backpressure); ``PagedDecodeEngine.run`` is a closed-loop wrapper over
it."""

from apex_tpu_torch.serving.frontend import (ServingError, ServingFrontend,
                                             StreamHandle)
from apex_tpu_torch.serving.kv_pool import (alloc_slot, alloc_slot_shared,
                                            defrag, defrag_map,
                                            drop_slot_pages,
                                            free_page_count, free_slot,
                                            init_paged_cache,
                                            max_slots_for_pool_bytes,
                                            page_bytes, pages_for,
                                            prefill_into_pages, release_slot)
from apex_tpu_torch.serving.policy import PriorityDeadlinePolicy
from apex_tpu_torch.serving.prefix_cache import PrefixCache
from apex_tpu_torch.serving.scheduler import (PagedDecodeEngine, Request,
                                              generate_paged,
                                              make_shared_admit,
                                              prompt_bucket)
from apex_tpu_torch.serving.tp import (TensorParallelPagedEngine,
                                       infer_variable_specs,
                                       shard_model_variables)

__all__ = ["PagedDecodeEngine", "PrefixCache", "PriorityDeadlinePolicy",
           "Request", "ServingError", "ServingFrontend", "StreamHandle",
           "TensorParallelPagedEngine", "infer_variable_specs",
           "shard_model_variables",
           "alloc_slot", "alloc_slot_shared", "defrag", "defrag_map",
           "drop_slot_pages", "free_page_count", "free_slot",
           "generate_paged", "init_paged_cache", "make_shared_admit",
           "max_slots_for_pool_bytes", "page_bytes", "pages_for",
           "prefill_into_pages", "prompt_bucket", "release_slot"]
