"""``python -m ddp_tpu_torch.parallel.tp`` — the plan table (counterpart of
``python -m ddp_tpu.parallel.tp``'s default mode).

The offline view of what the CLI prints at start-up under ``--mesh_shape``:
resolve the model's TP_RECIPE against its parameters (on the meta device)
at the given model-axis size (``--model_axis M``, or the M of
``--mesh_shape D,M``), validate it, print the plan table, and exit
non-zero on an infeasible plan.  The table has no predicted-cost column
(``analysis.costmodel``, ROADMAP A13c).  ``--search``, the auto-sharding
search, is refused by name (ROADMAP A13c).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ...models import ALL_NAMES, get_model
from .plan import format_plan_table, plan_for_model


def _model_axis(args: argparse.Namespace) -> int:
    if args.mesh_shape is None:
        return args.model_axis
    try:
        dims = [int(v) for v in args.mesh_shape.replace("x", ",").split(",")]
    except ValueError:
        dims = []
    if len(dims) != 2 or min(dims) < 1:
        raise SystemExit(f"--mesh_shape wants D,M (got {args.mesh_shape!r})")
    return dims[1]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.parallel.tp",
        description=__doc__.splitlines()[0])
    p.add_argument("--model", default="deepnn", choices=list(ALL_NAMES))
    p.add_argument("--model_axis", default=4, type=int, metavar="M",
                   help="model-axis size to plan for (default 4)")
    p.add_argument("--mesh_shape", default=None, metavar="D,M",
                   help="plan for the model axis M of this mesh instead")
    p.add_argument("--search", action="store_true",
                   help="refused: the auto-sharding search is not ported "
                        "(ROADMAP A13c)")
    args = p.parse_args(argv)
    if args.search:
        print("--search: the auto-sharding search (parallel/tp/autoplan.py) "
              "is not ported (ROADMAP A13c, with the analysis passes it "
              "prices candidates with)", file=sys.stderr)
        return 2
    try:
        plan = plan_for_model(args.model, get_model(args.model,
                                                    device="meta"),
                              model_size=_model_axis(args))
    except ValueError as e:
        print(f"infeasible plan: {e}", file=sys.stderr)
        return 1
    print(format_plan_table(plan))
    return 0


if __name__ == "__main__":
    sys.exit(main())
