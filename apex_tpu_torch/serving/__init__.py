"""Paged-KV continuous-batching serving (greedy, single GPU), over a
full-precision or a quantized page pool, with in-engine speculative decode
and chunked prefill."""

from apex_tpu_torch.serving.kv_pool import (alloc_slot, drop_slot_pages,
                                            free_page_count, free_slot,
                                            init_paged_cache,
                                            max_slots_for_pool_bytes,
                                            page_bytes, pages_for,
                                            prefill_into_pages, release_slot)
from apex_tpu_torch.serving.scheduler import (PagedDecodeEngine, Request,
                                              generate_paged, prompt_bucket)

__all__ = ["PagedDecodeEngine", "Request", "alloc_slot", "drop_slot_pages",
           "free_page_count", "free_slot", "generate_paged",
           "init_paged_cache",
           "max_slots_for_pool_bytes", "page_bytes", "pages_for",
           "prefill_into_pages", "prompt_bucket", "release_slot"]
