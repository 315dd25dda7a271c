"""``python -m ddp_tpu_torch.supervise [options] -- <training command>``: the
restart wrapper's entry point (counterpart of ``ddp_tpu/supervise.py``).
The logic is ``resilience/supervisor.py``'s; a child command that starts
with ``-m`` or a ``*.py`` file runs under this interpreter, e.g.

    python -m ddp_tpu_torch.supervise --max_restarts 3 -- \\
        -m ddp_tpu_torch.multigpu 10 1 --snapshot_path ck.pt \\
        --metrics_path m.jsonl
"""
from .resilience.supervisor import main

if __name__ == "__main__":
    raise SystemExit(main())
