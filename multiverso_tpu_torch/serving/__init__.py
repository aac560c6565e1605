"""Serving plane of the port: dynamic and continuous batching of
attention-LM decode on the card.

Port of ``multiverso_tpu/serving`` for the LM decode path:

* ``batcher``/``continuous`` — deadline-aware admission + pad-to-bucket
  micro-batching, and iteration-level continuous batching;
* ``pipeline`` — the depth-N dispatch window of the drain path;
* ``runners`` — :class:`AttentionLMRunner`, KV-cached greedy decode with
  a preallocated or a paged cache;
* ``paged``/``quant`` — the page pool and its storage codecs (f32, bf16,
  int8 with per-row scales);
* ``prefix`` — the prefix store: requests with one prompt share prefill
  work and KV pages;
* ``service``/``client`` — the DCN-framed request plane with concurrent
  in-flight requests.

The lookup runners, the hot-row cache, the checkpoint replica and shard
routing wait (ROADMAP A9).
"""

from multiverso_tpu_torch.serving.batcher import (BucketLadder,
                                                  DynamicBatcher,
                                                  ServeRequest, ShedError)
from multiverso_tpu_torch.serving.client import (ReplicaUnavailableError,
                                                 ServeResult, ServingClient,
                                                 connect_with_backoff)
from multiverso_tpu_torch.serving.continuous import ContinuousBatcher
from multiverso_tpu_torch.serving.paged import (PagePlan, PagePool,
                                                default_pool_pages,
                                                page_plan, pages_of)
from multiverso_tpu_torch.serving.pipeline import (DispatchPipeline,
                                                   resolve_pipeline_depth)
from multiverso_tpu_torch.serving.prefix import PrefixStore
from multiverso_tpu_torch.serving.runners import (AttentionLMRunner,
                                                  ServingRunner)
from multiverso_tpu_torch.serving.service import ServingService

__all__ = [
    "AttentionLMRunner", "BucketLadder", "ContinuousBatcher",
    "DispatchPipeline", "DynamicBatcher", "PagePlan", "PagePool",
    "PrefixStore", "ReplicaUnavailableError", "ServeRequest", "ServeResult",
    "ServingClient", "ServingRunner", "ServingService", "ShedError",
    "connect_with_backoff", "default_pool_pages", "page_plan", "pages_of",
    "resolve_pipeline_depth",
]
