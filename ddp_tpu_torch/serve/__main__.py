"""``python -m ddp_tpu_torch.serve`` — stand up a model server on a
checkpoint (counterpart of ``python -m ddp_tpu.serve``): one engine, or
with ``--fleet N`` N replicas behind the fault-tolerant router.

Loads the newest verifiable checkpoint under ``--snapshot_path`` (a head
file or a directory, through the checkpoint lineage: a torn head falls
back to a retained snapshot), makes one eval program per padded batch
bucket (on the card: one CUDA graph each, captured at startup), and serves
``/predict`` / ``/healthz`` / ``/stats`` / ``/metrics`` through a stdlib
threaded HTTP server in front of the dynamic batcher.  SIGTERM/SIGINT drain
gracefully through the preemption guard: admission stops (503 and a
draining ``/healthz``), accepted requests finish, the span spill is
flushed, exit 0.  A second signal kills at once.  It runs on ``cuda``
unless ``--device cpu`` is given, and refuses to run without a card
otherwise.  ``--bf16`` serves in bfloat16 compute, as the trainer's
``--bf16`` trains (``/stats`` reports the dtype).  ``--fleet N`` serves N
in-process replicas (each its own engine and graphs on the same card)
behind :class:`~ddp_tpu_torch.serve.router.Router`; ``--swap_poll_s S``
polls the lineage every S seconds and hot-swaps a newly published
verifiable snapshot in with zero downtime.  The serve faults of
``DDP_TPU_FAULT`` (``crash_replica``, ``slow_forward``, ``torn_publish``)
install on a fleet.

``--model tinylm --generate`` serves ``POST /generate`` token streams
instead: a KV-cache engine (prefill and cache-write programs for each
``--prefill_buckets`` bucket and one decode program over ``--slots``
slots; CUDA graphs on the card) behind a token-level continuous batcher,
alone or with ``--fleet N`` behind the router's sticky sessions.

Usage:
    python -m ddp_tpu_torch.singlegpu 5 1 --resident --snapshot_path ck.pt
    python -m ddp_tpu_torch.serve --snapshot_path ck.pt --port 8100 [--bf16]
    python -m ddp_tpu_torch.serve --snapshot_path ck.pt --fleet 2 \
        --swap_poll_s 2
    python -m ddp_tpu_torch.train.lm --snapshot_path lm/ck.npz
    python -m ddp_tpu_torch.serve --snapshot_path lm/ck.npz --model tinylm \
        --generate [--fleet 2]
    curl -s -X POST localhost:8100/generate -d '{"prompt": [1, 2, 3]}'
    curl -s localhost:8100/healthz
    curl -s -X POST localhost:8100/predict -d '{"instances": [[[..]]]}'
    python -m ddp_tpu.obs serve_spill.jsonl              # telemetry
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.serve",
        description=__doc__.splitlines()[0])
    p.add_argument("--snapshot_path", default="checkpoint.pt",
                   help="Checkpoint head file or the directory holding "
                        "it (the trainer's --snapshot_path; default: "
                        "checkpoint.pt); the newest verifiable snapshot "
                        "of its lineage is served")
    p.add_argument("--model", default="vgg",
                   choices=["vgg", "deepnn", "resnet18", "transformer",
                            "tinylm"],
                   help="Model architecture the checkpoint was trained "
                        "with (default: vgg — the reference's model); "
                        "tinylm + --generate serves token streams")
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address (default 127.0.0.1; 0.0.0.0 to "
                        "expose)")
    p.add_argument("--port", default=8100, type=int,
                   help="Listen port (default 8100; 0 picks a free port "
                        "and prints it)")
    p.add_argument("--buckets", default="1,8,32,128",
                   help="Padded batch buckets, comma-separated; each "
                        "bucket's program is made ONCE at startup (one CUDA "
                        "graph on the card) — the whole set, bounded and "
                        "known (default 1,8,32,128)")
    p.add_argument("--max_batch", default=None, type=int,
                   help="Batch-former row target (default: the largest "
                        "bucket)")
    p.add_argument("--max_wait_ms", default=5.0, type=float,
                   help="Batch-forming wait budget from the oldest queued "
                        "request (default 5 ms)")
    p.add_argument("--queue_depth", default=256, type=int,
                   help="Admission queue bound; a full queue sheds with "
                        "503 (default 256 requests)")
    p.add_argument("--generate", action="store_true",
                   help="Generative decoding mode: front the tinylm "
                        "decoder (models/transformer.py) with a KV-cache "
                        "engine + token-level continuous batcher and "
                        "serve POST /generate; /predict routes stay on "
                        "classifier servers only")
    p.add_argument("--slots", default=8, type=int,
                   help="Generative only: concurrent KV-cache streams "
                        "per replica (default 8)")
    p.add_argument("--prefill_buckets", default="16,64",
                   help="Generative only: padded prompt-length buckets, "
                        "comma-separated; prefill + cache-write programs "
                        "are made once per bucket (default 16,64)")
    p.add_argument("--max_new_tokens", default=32, type=int,
                   help="Generative only: per-request generation cap "
                        "(requests may ask for fewer; default 32)")
    p.add_argument("--fleet", default=0, type=int, metavar="N",
                   help="Serve N in-process engine replicas behind the "
                        "fault-tolerant router (health-driven ejection, "
                        "retry budgets, circuit breakers) instead of one "
                        "bare engine; 0 = single-engine mode (default)")
    p.add_argument("--swap_poll_s", default=0.0, type=float,
                   help="Fleet only: poll the checkpoint lineage every "
                        "this many seconds and hot-swap newly published "
                        "verifiable snapshots into rotation with zero "
                        "downtime (0 disables the watcher; default 0)")
    p.add_argument("--trace_spill", default=None, metavar="PATH",
                   help="Span spill (queue_wait/batch_form/pad/h2d/"
                        "forward/d2h), readable by python -m ddp_tpu.obs; "
                        "'' keeps no spill (default: serve_spill.jsonl "
                        "next to --snapshot_path)")
    p.add_argument("--obs_off", action="store_true",
                   help="Telemetry kill switch: no spans, no spill")
    p.add_argument("--bf16", action="store_true",
                   help="Serve in bfloat16 compute (match the flag the "
                        "checkpoint was trained with for parity)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..device import resolve_device, set_tf32
    from ..obs.registry import MetricsRegistry
    from ..obs.tracer import (NullTracer, SpanTracer, default_spill_path,
                              set_tracer)
    from ..resilience.faults import install_serve_faults
    from ..resilience.preemption import PreemptionGuard
    from .batcher import DynamicBatcher
    from .engine import ServeEngine
    from .fleet import ServeFleet
    from .http import ServeHTTPServer

    device = resolve_device(args.device)
    # As the trainer's CLI: full float32 convolutions and products, or the
    # served logits would differ from evaluate_resident's.
    set_tf32(False)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    trace_spill = args.trace_spill
    if trace_spill is None:
        trace_spill = default_spill_path(args.snapshot_path,
                                         "serve_spill.jsonl")
    tracer = (NullTracer() if args.obs_off
              else SpanTracer(spill_path=trace_spill or None, host=0))
    registry = MetricsRegistry()  # one /metrics surface per process
    buckets = [int(b) for b in args.buckets.split(",") if b]
    prefill_buckets = [int(b) for b in args.prefill_buckets.split(",") if b]
    try:
        set_tracer(tracer)
        print(f"loading checkpoint {args.snapshot_path!r} ...",
              file=sys.stderr)
        fleet = engine = batcher = None
        if args.fleet >= 1:
            t0 = time.monotonic()
            fleet = ServeFleet(
                args.snapshot_path, args.model, device=device,
                n_replicas=args.fleet, buckets=buckets,
                compute_dtype=compute_dtype, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms,
                queue_depth=args.queue_depth, tracer=tracer,
                registry=registry, generate=args.generate,
                slots=args.slots, prompt_buckets=prefill_buckets,
                max_new_tokens=args.max_new_tokens)
            install_serve_faults(fleet)
            fleet.start(poll_s=args.swap_poll_s)
            watcher = (f"every {args.swap_poll_s:.1f}s"
                       if args.swap_poll_s > 0 else "off")
            print(f"warmed {args.fleet} replica(s) in "
                  f"{time.monotonic() - t0:.1f}s (checkpoint step "
                  f"{fleet.health()['checkpoint_step']}; hot-swap watcher "
                  f"{watcher})", file=sys.stderr)
            httpd = ServeHTTPServer((args.host, args.port), fleet=fleet)
        elif args.generate:
            from .kvcache import KVCacheEngine
            from .token_batcher import TokenBatcher
            engine = KVCacheEngine.from_checkpoint(
                args.snapshot_path, args.model, device=device,
                slots=args.slots, prompt_buckets=prefill_buckets,
                compute_dtype=compute_dtype, tracer=tracer,
                registry=registry)
            t0 = time.monotonic()
            compiled = engine.warm()
            print(f"compiled {compiled} executable(s) (bound "
                  f"{engine.compile_bound}: prefill+write per prompt "
                  f"bucket {list(engine.prompt_buckets)} + 1 decode) in "
                  f"{time.monotonic() - t0:.1f}s (checkpoint "
                  f"{engine.checkpoint_file!r}, step "
                  f"{engine.checkpoint_step}); no stream pays a compile",
                  file=sys.stderr)
            batcher = TokenBatcher(engine,
                                   max_new_tokens=args.max_new_tokens,
                                   queue_depth=args.queue_depth,
                                   tracer=tracer,
                                   registry=registry).start()
            httpd = ServeHTTPServer((args.host, args.port), engine, batcher)
        else:
            engine = ServeEngine.from_checkpoint(
                args.snapshot_path, args.model, device=device,
                buckets=buckets, compute_dtype=compute_dtype, tracer=tracer,
                registry=registry)
            t0 = time.monotonic()
            # The JAX server's line, word for word: on the card each
            # executable is one captured CUDA graph.
            compiled = engine.warm()
            print(f"compiled {compiled} bucket executable(s) "
                  f"{list(engine.buckets)} in {time.monotonic() - t0:.1f}s "
                  f"(checkpoint {engine.checkpoint_file!r}, epoch "
                  f"{engine.checkpoint_epoch}); no request pays a compile",
                  file=sys.stderr)
            batcher = DynamicBatcher(engine, max_batch=args.max_batch,
                                     max_wait_ms=args.max_wait_ms,
                                     queue_depth=args.queue_depth,
                                     tracer=tracer,
                                     registry=registry).start()
            httpd = ServeHTTPServer((args.host, args.port), engine, batcher)
        listener = threading.Thread(target=httpd.serve_forever,
                                    daemon=True, name="serve-http")
        listener.start()
        # Graceful drain on SIGTERM/SIGINT (main thread only; an embedder
        # on another thread stops through drain()/close()).
        guard = (PreemptionGuard().install()
                 if threading.current_thread() is threading.main_thread()
                 else None)
        host, port = httpd.server_address[:2]
        what = (f"{args.model} fleet of {args.fleet}" if fleet is not None
                else args.model)
        routes = "/generate" if args.generate else "/predict"
        print(f"serving {what} on http://{host}:{port} "
              f"({routes} /healthz /stats /metrics); SIGTERM drains "
              "gracefully", flush=True)
        try:
            while guard is None or not guard.noticed():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass  # a second Ctrl-C during shutdown lands here; drain anyway
        print("draining: admission stopped, serving accepted requests ...",
              file=sys.stderr)
        if fleet is not None:
            drained = fleet.close(timeout=30.0)
        else:
            drained = batcher.drain(timeout=30.0)
        httpd.close()
        if guard is not None:
            guard.uninstall()
        stats = (fleet.stats() if fleet is not None else
                 {"engine": engine.stats(), "batcher": batcher.stats()})
        print(json.dumps(stats), file=sys.stderr)
        print(f"drained={'clean' if drained else 'FORCED'}; bye",
              file=sys.stderr)
        return 0 if drained else 1
    finally:
        set_tracer(NullTracer())
        tracer.flush(fsync=True)
        tracer.close()


if __name__ == "__main__":
    raise SystemExit(main())
