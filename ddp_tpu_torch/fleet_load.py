"""CI fleet-smoke load client: concurrent /predict load with an exact
ok / shed / failed ledger (counterpart of ``tools/ci_fleet_load.py``; a
copy, since the port imports nothing of the tree it replaces: a fix to
either is made to both).

    python -m ddp_tpu_torch.fleet_load [--base URL] [--secs 20] [--conc 3]
                                       [--out fleet_load.json]

Drives the ``python -m ddp_tpu_torch.serve --fleet N`` stack from outside
the process (real HTTP, like the chaos drill's clients) while CI kills a
replica via ``DDP_TPU_FAULT`` and republishes the checkpoint mid-load.
The contract under both events is ZERO failed requests: every request is
either answered (2xx) or explicitly shed (503 + Retry-After, honored
with a short pause) — never errored, never hung.

Writes ``--out`` JSON (``{"ok": .., "shed": .., "failed": ..}``) and
exits 0 only when nothing failed, so the CI step's own exit code carries
the assertion.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default="http://127.0.0.1:8198",
                    help="Server base URL (default http://127.0.0.1:8198)")
    ap.add_argument("--secs", default=20.0, type=float,
                    help="Load duration (default 20 s)")
    ap.add_argument("--conc", default=3, type=int,
                    help="Concurrent client threads (default 3)")
    ap.add_argument("--out", default="fleet_load.json",
                    help="Ledger JSON path (default fleet_load.json)")
    args = ap.parse_args(argv)

    counts = {"ok": 0, "shed": 0, "failed": 0}
    lock = threading.Lock()
    deadline = time.monotonic() + args.secs

    def client(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while time.monotonic() < deadline:
            n = int(rng.integers(1, 5))
            body = json.dumps({"instances": rng.integers(
                0, 256, (n, 32, 32, 3)).tolist()}).encode()
            req = urllib.request.Request(
                args.base + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    out = json.load(r)
                good = len(out.get("predictions", [])) == n
            except urllib.error.HTTPError as e:
                if e.code == 503:      # explicit shed: honor the hint
                    with lock:
                        counts["shed"] += 1
                    time.sleep(min(float(
                        e.headers.get("Retry-After", 1) or 1), 0.25))
                    continue
                good = False           # 4xx/5xx besides shed: a failure
            except Exception:
                good = False           # transport error / timeout / reset
            with lock:
                counts["ok" if good else "failed"] += 1

    threads = [threading.Thread(target=client, args=(seed,))
               for seed in range(args.conc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(args.out, "w") as f:
        json.dump(counts, f)
    print(f"fleet load: {counts}")
    if counts["failed"] or not counts["ok"]:
        print("FAILED: client requests errored (or none succeeded) during "
              "the drill", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
