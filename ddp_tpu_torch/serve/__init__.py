"""Serving of the port (counterpart of ``ddp_tpu/serve/``, its single-engine
path): a trainer checkpoint turned into answered ``/predict`` requests.

- ``engine``   :class:`ServeEngine`: a v1 checkpoint, one eval program per
               padded batch bucket, warmed at startup; on the card each is
               one CUDA graph whose input comes through the ``gather_batch``
               kernel.
- ``batcher``  :class:`DynamicBatcher`: bounded admission queue, batches
               formed on ``max_batch`` or ``max_wait_ms``, explicit
               backpressure, graceful drain.
- ``http``     :class:`ServeHTTPServer`: ``/predict``, ``/healthz``,
               ``/stats``, ``/metrics``.
- ``__main__`` ``python -m ddp_tpu_torch.serve``; SIGTERM drains.

The fleet (router, replicas, hot-swap) and generative serving are not
ported yet (ROADMAP queue A9 and A12).
"""
from .batcher import Draining, DynamicBatcher, QueueFull, percentiles
from .engine import (RequestTooLarge, ServeEngine, ServeError,
                     claim_batch_seq, resolve_buckets)
from .http import NotPorted, ServeHTTPServer

__all__ = [
    "Draining", "DynamicBatcher", "NotPorted", "QueueFull", "RequestTooLarge",
    "ServeEngine", "ServeError", "ServeHTTPServer", "claim_batch_seq",
    "percentiles", "resolve_buckets",
]
