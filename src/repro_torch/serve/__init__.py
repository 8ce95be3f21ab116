"""Serving: continuous batching over a paged KV cache."""
from .cache import (PageAllocator, PagedKVCache, blocks_for_tokens,
                    pack_prefill_pages)
from .engine import (ContinuousEngine, Request, ServingEngine, make_engine,
                     run_sequential)
from .lifecycle import (CANCELLED, DECODING, EXPIRED, FAILED, FINISHED,
                        LIVE_STATES, PREFILLING, QUEUED, TERMINAL_STATES,
                        EngineStallError, RequestError, transition)
from .sampling import SamplingParams, greedy, sample_token
from .scheduler import FCFSScheduler, plan_aware_live_tokens

__all__ = [
    "PageAllocator", "PagedKVCache", "blocks_for_tokens",
    "pack_prefill_pages", "FCFSScheduler", "plan_aware_live_tokens",
    "SamplingParams", "greedy", "sample_token",
    "Request", "ServingEngine", "ContinuousEngine", "make_engine",
    "run_sequential",
    "QUEUED", "PREFILLING", "DECODING",
    "FINISHED", "CANCELLED", "EXPIRED", "FAILED",
    "TERMINAL_STATES", "LIVE_STATES", "transition",
    "RequestError", "EngineStallError",
]
