"""Serving plane of the port: continuous-batching consensus inference over
a swarm's stacked ensemble ``[N, P]``, with zero-downtime hot-swap. Port of
``repro.serve``."""
from repro_torch.serve.batcher import BucketPolicy
from repro_torch.serve.engine import AGG_MODES, ServeEngine, aggregate_logits
from repro_torch.serve.hot_swap import HotSwapSlot
from repro_torch.serve.queue import Request, RequestQueue

__all__ = ["AGG_MODES", "BucketPolicy", "HotSwapSlot", "Request",
           "RequestQueue", "ServeEngine", "aggregate_logits"]
