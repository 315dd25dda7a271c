"""Serving of the port (counterpart of ``ddp_tpu/serve/``): a trainer
checkpoint turned into answered ``/predict`` requests, or a ``tinylm``
checkpoint into ``/generate`` token streams, by one engine or by a
fault-tolerant fleet.

- ``engine``   :class:`ServeEngine`: a checkpoint, one eval program per
               padded batch bucket, warmed at startup; on the card each is
               one CUDA graph whose input comes through the ``gather_batch``
               kernel.
- ``batcher``  :class:`DynamicBatcher`: bounded admission queue, batches
               formed on ``max_batch`` or ``max_wait_ms``, explicit
               backpressure, graceful drain.
- ``kvcache``  :class:`KVCacheEngine`: the LM's prefill and cache-write
               programs for each prompt bucket and its one decode program
               over a KV cache written in place (CUDA graphs on the card).
- ``token_batcher`` :class:`TokenBatcher`: continuous batching at token
               granularity over the engine's slots.
- ``router``   :class:`Router`: health-driven ejection, retries inside a
               deadline budget, per-replica :class:`CircuitBreaker`, and
               sheds with a derived ``Retry-After``.
- ``fleet``    :class:`ServeFleet`: N (engine, batcher) replicas
               (:class:`LocalReplica`; :class:`HTTPReplica` for a remote
               server) behind the router, with the checkpoint hot-swap
               watcher.
- ``http``     :class:`ServeHTTPServer`: ``/predict``, ``/generate``,
               ``/healthz``, ``/stats``, ``/metrics`` in front of a pair
               or a fleet.
- ``model_group`` :class:`ModelGroup`: the M ranks of a KV-cache engine
               at a serving model axis M (rank 0 here, M - 1 follower
               processes), its gloo sums and the headers of rank 0's
               calls.
- ``__main__`` ``python -m ddp_tpu_torch.serve [--fleet N]``; SIGTERM
               drains.
"""
from .batcher import Draining, DynamicBatcher, QueueFull, percentiles
from .engine import (RequestTooLarge, ServeEngine, ServeError,
                     claim_batch_seq, resolve_buckets)
from .fleet import HTTPReplica, LocalReplica, ServeFleet
from .http import ServeHTTPServer
from .kvcache import KVCacheEngine, SlotsExhausted
from .model_group import ModelGroup
from .token_batcher import TokenBatcher
from .router import (CircuitBreaker, NoHealthyReplicas, ReplicaCrashed,
                     Router, RouterDraining, RouterOverloaded, RouterShed)

__all__ = [
    "CircuitBreaker", "Draining", "DynamicBatcher", "HTTPReplica",
    "KVCacheEngine", "LocalReplica", "ModelGroup", "NoHealthyReplicas",
    "QueueFull",
    "ReplicaCrashed", "RequestTooLarge", "Router", "RouterDraining",
    "RouterOverloaded", "RouterShed", "ServeEngine", "ServeError",
    "ServeFleet", "ServeHTTPServer", "SlotsExhausted", "TokenBatcher",
    "claim_batch_seq", "percentiles", "resolve_buckets",
]
