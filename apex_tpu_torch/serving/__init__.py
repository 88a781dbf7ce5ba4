"""Paged-KV continuous-batching serving (greedy, single GPU)."""

from apex_tpu_torch.serving.kv_pool import (alloc_slot, free_page_count,
                                            free_slot, init_paged_cache,
                                            pages_for, prefill_into_pages,
                                            release_slot)
from apex_tpu_torch.serving.scheduler import (PagedDecodeEngine, Request,
                                              generate_paged, prompt_bucket)

__all__ = ["PagedDecodeEngine", "Request", "alloc_slot", "free_page_count",
           "free_slot", "generate_paged", "init_paged_cache", "pages_for",
           "prefill_into_pages", "prompt_bucket", "release_slot"]
