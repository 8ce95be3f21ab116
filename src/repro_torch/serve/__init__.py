"""Serving: continuous batching over a paged KV cache, the static
baseline, chunked prefill, preemption, prefix sharing, faults and
snapshots."""
from .cache import (PageAllocator, PagedKVCache, blocks_for_tokens,
                    pack_prefill_pages)
from .chunked import (ChunkedPrefillState, chunk_cache_len, mask_cache_rows,
                      run_one_chunk, slice_cache, trim_cache)
from .engine import (ContinuousEngine, Request, ServingEngine, StaticEngine,
                     make_engine, run_sequential)
from .faults import FAULT_KINDS, FaultEvent, FaultInjector, FaultSchedule
from .lifecycle import (CANCELLED, DECODING, EXPIRED, FAILED, FINISHED,
                        LIVE_STATES, PREFILLING, QUEUED, TERMINAL_STATES,
                        EngineStallError, RequestError, transition)
from .prefix import PrefixIndex, PrefixPlan
from .sampling import SamplingParams, greedy, sample_token
from .scheduler import FCFSScheduler, plan_aware_live_tokens
from .snapshot import SNAPSHOT_VERSION, restore_engine, save_engine

__all__ = [
    "PageAllocator", "PagedKVCache", "blocks_for_tokens",
    "pack_prefill_pages",
    "ChunkedPrefillState", "chunk_cache_len", "mask_cache_rows",
    "run_one_chunk", "slice_cache", "trim_cache",
    "FCFSScheduler", "plan_aware_live_tokens",
    "PrefixIndex", "PrefixPlan",
    "SamplingParams", "greedy", "sample_token",
    "Request", "ServingEngine", "ContinuousEngine", "StaticEngine",
    "make_engine", "run_sequential",
    "QUEUED", "PREFILLING", "DECODING",
    "FINISHED", "CANCELLED", "EXPIRED", "FAILED",
    "TERMINAL_STATES", "LIVE_STATES", "transition",
    "RequestError", "EngineStallError",
    "FAULT_KINDS", "FaultEvent", "FaultSchedule", "FaultInjector",
    "SNAPSHOT_VERSION", "save_engine", "restore_engine",
]
