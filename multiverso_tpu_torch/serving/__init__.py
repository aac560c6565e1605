"""Serving plane of the port: row lookups over PS tables and checkpoint
replicas, and dynamic and continuous batching of attention-LM decode, on
the card.

Port of ``multiverso_tpu/serving``:

* ``batcher``/``continuous`` — deadline-aware admission + pad-to-bucket
  micro-batching, and iteration-level continuous batching;
* ``pipeline`` — the depth-N dispatch window of the drain path;
* ``runners`` — live-table row lookup (bitwise ``table.get_rows``),
  frozen-replica lookup, and :class:`AttentionLMRunner`, KV-cached greedy
  decode with a preallocated or a paged cache;
* ``cache`` — the hot-row LRU cache with bounded staleness in front of
  the lookup runners;
* ``replica`` — the checkpoint-to-serving handoff with atomic hot-swap;
* ``paged``/``quant`` — the page pool and its storage codecs (f32, bf16,
  int8 with per-row scales);
* ``prefix`` — the prefix store: requests with one prompt share prefill
  work and KV pages;
* ``service``/``client`` — the DCN-framed request plane with concurrent
  in-flight requests and shard routing.
"""

from multiverso_tpu_torch.serving.batcher import (BucketLadder,
                                                  DynamicBatcher,
                                                  ServeRequest, ShedError)
from multiverso_tpu_torch.serving.cache import (CacheAutosizer, HotRowCache,
                                                StampedRows, cache_from_flags)
from multiverso_tpu_torch.serving.client import (ReplicaUnavailableError,
                                                 RoutedLookupClient,
                                                 ServeResult, ServingClient,
                                                 backoff_delays,
                                                 connect_with_backoff)
from multiverso_tpu_torch.serving.continuous import ContinuousBatcher
from multiverso_tpu_torch.serving.paged import (PagePlan, PagePool,
                                                default_pool_pages,
                                                page_plan, pages_of)
from multiverso_tpu_torch.serving.pipeline import (DispatchPipeline,
                                                   resolve_pipeline_depth)
from multiverso_tpu_torch.serving.prefix import PrefixStore
from multiverso_tpu_torch.serving.replica import (CheckpointReplica,
                                                  ReplicaSnapshot,
                                                  load_checkpoint_tables)
from multiverso_tpu_torch.serving.runners import (AttentionLMRunner,
                                                  ReplicaLookupRunner,
                                                  ServingRunner,
                                                  SparseLookupRunner)
from multiverso_tpu_torch.serving.service import ServingService

__all__ = [
    "AttentionLMRunner", "BucketLadder", "CacheAutosizer",
    "CheckpointReplica", "ContinuousBatcher", "DispatchPipeline",
    "DynamicBatcher", "HotRowCache", "PagePlan", "PagePool", "PrefixStore",
    "ReplicaLookupRunner", "ReplicaSnapshot", "ReplicaUnavailableError",
    "RoutedLookupClient", "ServeRequest", "ServeResult", "ServingClient",
    "ServingRunner", "ServingService", "ShedError", "SparseLookupRunner",
    "StampedRows", "backoff_delays", "cache_from_flags",
    "connect_with_backoff", "default_pool_pages", "load_checkpoint_tables",
    "page_plan", "pages_of", "resolve_pipeline_depth",
]
