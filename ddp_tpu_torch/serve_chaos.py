"""Mid-stream replica-crash drill for the GENERATIVE serving fleet (the
port's copy of ``tools/serve_chaos.py``; PASS rules unchanged).

The training chaos campaign proves the train loop survives kills; this
drill proves the serving fleet's sticky-session machinery survives losing
the replica that holds a conversation's KV cache, the failure new to
generative serving, where a request is no longer stateless.

Scenario (in-process, on one ``--device``):

1. Train a tiny LM (or reuse ``--snapshot``), stand up a 2-replica
   generative fleet, and run S sticky sessions, each a multi-turn
   conversation: every turn submits the FULL token history and appends
   the generated tokens.
2. After the first turn (every session now pinned), latch the crash
   fault on a replica holding at least one pin.
3. Run the remaining turns.  Every turn must complete: the router
   re-routes around the dead replica, re-pins the session (a counted
   MIGRATION), and the new replica re-prefills the full history.
4. Replay every conversation on an untouched single-engine reference and
   require TOKEN-IDENTICAL output: a migration must not change what the
   model says, only where it says it.

PASS iff zero failed turns, >= 1 migration, the crashed replica was
ejected by the health prober, and every continuation matches the
reference.  Scorecard (``--out``)::

    python -m ddp_tpu_torch.serve_chaos --out CHAOS_r03.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional


def run_drill(snapshot: Optional[str], *, device="cuda", sessions: int = 4,
              turns: int = 3, turn_tokens: int = 4,
              prompt_len: int = 4) -> dict:
    from .device import resolve_device
    from .models import transformer as tfm
    from .serve.fleet import ServeFleet
    from .serve.kvcache import KVCacheEngine

    device = resolve_device(device)
    tmp = None
    if snapshot is None:
        from .train.lm import train_lm
        tmp = tempfile.TemporaryDirectory(prefix="serve_chaos_")
        snapshot = os.path.join(tmp.name, "ckpt.npz")
        train_lm(steps=5, batch=8, seq_len=16, device=device,
                 snapshot_path=snapshot, quiet=True)

    record = {"drill": "generate_replica_crash", "sessions": sessions,
              "turns": turns, "replicas": 2, "device": str(device)}
    t0 = time.monotonic()
    fleet = ServeFleet(snapshot, tfm.LM_NAME, device=device, n_replicas=2,
                       generate=True, slots=4, prompt_buckets=(16, 64),
                       max_new_tokens=turn_tokens,
                       router_kwargs={"health_interval_s": 0.1,
                                      "eject_after": 2})
    fleet.start(poll_s=0)  # health prober only; no checkpoint watcher
    failed_turns: List[str] = []
    histories = {}
    try:
        for s in range(sessions):
            histories[f"s{s}"] = [1 + (7 * s + i) % 250
                                  for i in range(prompt_len)]
        # Turn 1: every session pins to whichever replica served it.
        for sid, hist in histories.items():
            out = fleet.generate(hist, max_new_tokens=turn_tokens,
                                 timeout=60, session=sid)
            hist.extend(out["tokens"])
        pins = {sid: fleet.router.session_replica(sid)
                for sid in histories}
        # Crash a replica that holds at least one pin, mid-campaign.
        victim_id = next(rid for rid in pins.values() if rid is not None)
        victim = next(r for r in fleet.replicas
                      if r.replica_id == victim_id)
        pinned_to_victim = sum(1 for rid in pins.values()
                               if rid == victim_id)
        victim.crashed = True
        record["crashed_replica"] = victim_id
        record["sessions_pinned_to_victim"] = pinned_to_victim
        # Remaining turns: every one must complete despite the dead replica.
        for turn in range(1, turns):
            for sid, hist in histories.items():
                try:
                    out = fleet.generate(hist,
                                         max_new_tokens=turn_tokens,
                                         timeout=60, session=sid)
                    hist.extend(out["tokens"])
                except Exception as e:
                    failed_turns.append(
                        f"{sid}@turn{turn}: {type(e).__name__}: {e}")
        # Give the prober a beat to register the ejection.
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                fleet.router.stats()["ejections"] < 1:
            time.sleep(0.05)
        rstats = fleet.router.stats()
        record["failed_turns"] = failed_turns
        record["migrations"] = rstats["session_migrations"]
        record["ejections"] = rstats["ejections"]
        record["post_crash_pins"] = {
            sid: fleet.router.session_replica(sid) for sid in histories}
    finally:
        fleet.close(timeout=15)

    # Reference replay: one untouched engine; greedy decode is
    # deterministic, so the whole conversation must reproduce exactly.
    eng = KVCacheEngine.from_checkpoint(snapshot, tfm.LM_NAME, device=device,
                                        slots=4, prompt_buckets=(16, 64))
    eng.warm()
    mismatches = []
    for s in range(sessions):
        sid = f"s{s}"
        hist = [1 + (7 * s + i) % 250 for i in range(prompt_len)]
        for _ in range(turns):
            slot, tok = eng.start_stream(hist)
            got = [tok]
            for _ in range(turn_tokens - 1):
                tok = eng.decode({slot: tok})[slot]
                got.append(tok)
            eng.release(slot)
            hist.extend(got)
        if hist != histories[sid]:
            mismatches.append(sid)
    if tmp is not None:
        tmp.cleanup()

    record["reference_mismatches"] = mismatches
    record["wall_s"] = round(time.monotonic() - t0, 1)
    record["zero_failed_streams"] = not failed_turns
    record["pass"] = (not failed_turns
                      and record["migrations"] >= 1
                      and record["ejections"] >= 1
                      and not mismatches)
    return record


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.serve_chaos",
        description="Mid-stream replica-crash drill for the generative "
                    "serving fleet (sticky sessions + KV-cache "
                    "recompute-on-migrate).")
    p.add_argument("--out", default="CHAOS_r03.json",
                   help="Scorecard path (default CHAOS_r03.json)")
    p.add_argument("--snapshot", default=None,
                   help="Trained tinylm checkpoint to serve (default: "
                        "train a fresh 5-step one in a tempdir)")
    p.add_argument("--sessions", default=4, type=int)
    p.add_argument("--turns", default=3, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    args = p.parse_args(argv)

    from .device import set_tf32
    set_tf32(False)
    record = run_drill(args.snapshot, device=args.device,
                       sessions=args.sessions, turns=args.turns)
    card = {
        "schema": "serve_chaos/1",
        "generated_by": "python -m ddp_tpu_torch.serve_chaos",
        "drills": {"generate_replica_crash": record},
        "verdict": "PASS" if record["pass"] else "FAIL",
    }
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(card, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"[serve-chaos] scorecard written to {args.out}: "
          f"{card['verdict']} (migrations={record['migrations']}, "
          f"failed={len(record['failed_turns'])}, "
          f"mismatches={len(record['reference_mismatches'])})")
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
