"""``python -m ddp_tpu_torch.parallel.pp`` — the offline stage table
(counterpart of ``python -m ddp_tpu.parallel.pp``).

Resolve the model's PP_BLOCKS into a balanced ``--stages``-way cut (priced
with the per-layer forward flops of its layers, on the meta device), print
the stage table the CLI prints at start-up under a 3-D ``--mesh_shape``,
and exit 1 on an infeasible partition, with the JAX package's text and
exit codes.  ``--model_size`` restricts the cut set as the live
``(d, m, s)`` mesh would; ``--microbatches`` adds the predicted-bubble
line.
"""
from __future__ import annotations

import argparse
import sys

from .partition import format_stage_table, plan_stages


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.parallel.pp",
        description="pipeline stage partitioner (offline stage table)")
    ap.add_argument("--model", default="deepnn")
    ap.add_argument("--stages", type=int, default=2,
                    help="stage count s (the mesh's third axis)")
    ap.add_argument("--model_size", type=int, default=1,
                    help="tensor-parallel m the stages compose with "
                         "(restricts cut points to full-width boundaries)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="print the predicted bubble fraction at this "
                         "microbatch count")
    args = ap.parse_args(argv)

    from ...models import get_model
    try:
        model = get_model(args.model, device="meta")
        plan = plan_stages(args.model, args.stages,
                           model_size=args.model_size, model=model)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    print(format_stage_table(plan, num_micro=args.microbatches))
    return 0


if __name__ == "__main__":
    sys.exit(main())
