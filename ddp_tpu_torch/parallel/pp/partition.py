"""The stage partitioner (counterpart of
``ddp_tpu/parallel/pp/partition.py``), the pipeline analogue of
``tp/plan.py``.

A model opts in by declaring ``PP_BLOCKS``: its forward as an ordered
tuple of cut-able units (each a TP_RECIPE layer and its trailing
elementwise/pool/reshape ops, ``models/deepnn.py``), so a cut between any
two blocks is a clean activation handoff.  :func:`plan_stages` picks the
balanced contiguous s-way partition of that list, priced with the
per-layer forward-flop table of :func:`layer_forward_costs` (the JAX
package's ``analysis/costmodel.py::layer_forward_costs``, computed here
from the layers' shapes): min-max stage cost over the valid cut set, every
constraint violation reported at once, and the stage table
(:func:`format_stage_table`) whose first line is the schema anchor, in the
JAX package's words and figures.

Under tensor parallelism (m > 1) a ``column`` layer's output is
model-sharded, and a cut there would hand a sharded activation to another
set of ranks: the model's ``PP_SHARDED_OUT`` names those blocks and the
planner rejects cuts after them.
"""
from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Optional, Tuple

# Registry name -> module name where it differs (as tp/plan.py's).
_MODULE_FOR = {"resnet18": "resnet", "tinylm": "transformer"}


class StagePlan(NamedTuple):
    """A resolved s-way stage partition for one model."""
    model_name: str
    num_stages: int
    # ((lo, hi), ...) half-open PP_BLOCKS index ranges, one per stage,
    # covering the whole block list contiguously.
    stages: Tuple[Tuple[int, int], ...]
    block_names: Tuple[str, ...]          # the model's PP_BLOCKS
    # Per-stage summed forward flops/image (the balance the cut minimises).
    stage_costs: Tuple[float, ...]
    uniform_costs: bool = False           # True when no cost table matched


def _blocks_for(model_name: str):
    mod = importlib.import_module(
        f"ddp_tpu_torch.models.{_MODULE_FOR.get(model_name, model_name)}")
    return (getattr(mod, "PP_BLOCKS", None),
            tuple(getattr(mod, "PP_SHARDED_OUT", ()) or ()))


def layer_forward_costs(model_name: str, model) -> Optional[Dict[str, int]]:
    """``{recipe layer path: forward flops per image}`` of ``model`` (a
    port model; the meta device will do): one image through the forward,
    each recipe layer priced as the JAX cost model prices its convolution
    or dot, ``2 * output elements * contraction`` (a conv's contraction is
    ``Cin * kh * kw``, a linear's its input width).  None when the model
    has no recipe, a recipe layer holds no weight, the forward runs no
    hooked module for some recipe layer (the transformer encoder calls its
    layers functionally, and the JAX cost model does not match its
    attention products to the recipe either), or the model takes tokens,
    not images (``tinylm``)."""
    import torch
    from ... import interop
    from ..tp.plan import _recipe_for
    if getattr(model, "workload", None) == "lm":
        return None
    try:
        recipe, _ = _recipe_for(model_name)
    except ValueError:
        return None
    owner: Dict[str, str] = {}  # module name -> recipe layer path
    for key, _ in model.named_parameters():
        if not key.endswith(".weight"):
            continue
        path, _ = interop.rule_of(model_name, key)
        layer = path.rsplit("/", 1)[0]
        if layer in recipe:
            owner[key[:-len(".weight")]] = layer
    if set(owner.values()) != set(recipe):
        return None
    out: Dict[str, int] = {}
    handles = []

    def hook(name):
        def record(module, inputs, output):
            w = module.weight
            contraction = int(w[0].numel())  # Cin*kh*kw, or in_features
            out[owner[name]] = 2 * int(output[0].numel()) * contraction
        return record

    modules = dict(model.named_modules())
    for name in owner:
        handles.append(modules[name].register_forward_hook(hook(name)))
    device = next(model.parameters()).device
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros((1, 3, 32, 32), device=device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    if set(out) != set(recipe):
        return None
    return {k: out[k] for k in recipe}


def block_costs(model_name: str, model=None) -> Optional[Dict[str, float]]:
    """``{block name: forward flops/image}`` from :func:`layer_forward_costs`
    (block names ARE recipe layer paths), or None when no model was given
    or the table does not map onto the recipe."""
    if model is None:
        return None
    table = layer_forward_costs(model_name, model)
    return None if table is None else {k: float(v) for k, v in table.items()}


def plan_stages(model_name: str, num_stages: int, *, model_size: int = 1,
                model=None, costs: Optional[Dict[str, float]] = None
                ) -> StagePlan:
    """Resolve the balanced ``num_stages``-way cut of ``model_name``'s
    PP_BLOCKS.  ``model_size`` (the mesh's m) restricts the cut set to
    full-width activation boundaries; ``model`` (a port model, the meta
    device will do) prices the blocks, and ``costs`` overrides that table
    (tests inject imbalance with it); without either the costs are
    uniform.  Every violation is reported at once, in the JAX package's
    words."""
    errors = []
    s = int(num_stages)
    blocks, sharded_out = _blocks_for(model_name)
    if not blocks:
        raise ValueError(
            f"model {model_name!r} declares no PP_BLOCKS; pipeline "
            "parallelism needs the model's forward as an ordered block "
            "list (see models/deepnn.py) — run it with stage axis s=1, "
            "or add the block list")
    if s < 1:
        errors.append(f"stage count must be positive, got {num_stages}")
    if s > len(blocks):
        errors.append(
            f"stage count {s} exceeds the model's {len(blocks)} blocks "
            f"({', '.join(blocks)}) — there are not enough cut points")
    # Valid cut points: the boundary AFTER block i (i in 0..n-2).  Under
    # m > 1 a cut after a model-sharded-output block is invalid.
    n = len(blocks)
    valid = [i for i in range(n - 1)
             if not (model_size > 1 and blocks[i] in sharded_out)]
    if not errors and s - 1 > len(valid):
        banned = [b for b in blocks[:-1] if b in sharded_out]
        errors.append(
            f"stage count {s} needs {s - 1} cut points but only "
            f"{len(valid)} boundaries hand over a full-width activation "
            f"under model axis m={model_size} (cuts after column layers "
            f"{banned} would hand over a model-sharded activation)")
    if errors:
        raise ValueError(
            f"cannot cut {model_name!r} into {num_stages} pipeline "
            f"stage(s) at model axis size {model_size}:\n"
            + "\n".join(f"  - {e}" for e in errors))

    if costs is None:
        costs = block_costs(model_name, model)
    uniform = costs is None
    per_block = ([1.0] * n if uniform
                 else [float(costs.get(b, 0.0)) for b in blocks])

    cuts = _balanced_cuts(per_block, s, set(valid))
    bounds = [0] + [c + 1 for c in cuts] + [n]
    stages = tuple((bounds[i], bounds[i + 1]) for i in range(s))
    stage_costs = tuple(float(sum(per_block[lo:hi])) for lo, hi in stages)
    return StagePlan(model_name, s, stages, tuple(blocks), stage_costs,
                     uniform_costs=uniform)


def _balanced_cuts(per_block, s: int, valid: set) -> Tuple[int, ...]:
    """The s-1 cut points (boundary indices, 'after block i') minimising
    the maximum stage cost over contiguous partitions whose every cut is
    in ``valid``: exact DP over (block prefix, stages used), O(n^2 s)."""
    n = len(per_block)
    prefix = [0.0]
    for c in per_block:
        prefix.append(prefix[-1] + c)

    def seg(i, j):  # cost of blocks [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # best[k][j] = minimal max-stage-cost cutting blocks [0, j) into k
    # stages; arg[k][j] = the i achieving it (last stage is [i, j)).
    best = [[INF] * (n + 1) for _ in range(s + 1)]
    arg = [[0] * (n + 1) for _ in range(s + 1)]
    best[0][0] = 0.0
    for k in range(1, s + 1):
        for j in range(1, n + 1):
            for i in range(k - 1, j):
                # the cut before this last stage sits after block i-1
                if k > 1 and (i - 1) not in valid:
                    continue
                cand = max(best[k - 1][i], seg(i, j))
                if cand < best[k][j]:
                    best[k][j] = cand
                    arg[k][j] = i
    cuts = []
    j = n
    for k in range(s, 1, -1):
        i = arg[k][j]
        cuts.append(i - 1)
        j = i
    return tuple(reversed(cuts))


def predicted_bubble(num_stages: int, num_micro: int) -> float:
    """The schedule's static bubble fraction, (s-1)/(A+s-1): of the A+s-1
    pipeline clocks a full forward+backward wave needs, s-1 are ramp (the
    same for GPipe and 1F1B at uniform stage cost; 1F1B's win is in-flight
    activation memory, min(s, A) against A micro-batches)."""
    s, a = int(num_stages), int(num_micro)
    if s < 1 or a < 1:
        raise ValueError(f"need s>=1 and A>=1, got s={num_stages}, "
                         f"A={num_micro}")
    return (s - 1) / (a + s - 1)


def stage_param_paths(plan: StagePlan, k: int) -> Tuple[Tuple[str, ...],
                                                        ...]:
    """Tree paths owned by stage ``k``: block name ``"a/b"`` IS subtree
    ``params["a"]["b"]`` (the PP_BLOCKS contract)."""
    lo, hi = plan.stages[k]
    return tuple(tuple(name.split("/")) for name in plan.block_names[lo:hi])


def stage_subtree(plan: StagePlan, k: int, tree):
    """Stage ``k``'s slice of a params-shaped tree: the same dict shape
    with only that stage's block subtrees present."""
    out: dict = {}
    for path in stage_param_paths(plan, k):
        node = tree
        for key in path:
            node = node[key]
        dst = out
        for key in path[:-1]:
            dst = dst.setdefault(key, {})
        dst[path[-1]] = node
    return out


def merge_subtrees(parts) -> dict:
    """Inverse of :func:`stage_subtree`: the whole params-shaped tree from
    the per-stage slices."""
    out: dict = {}

    def merge(dst, src):
        for key, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(key, {}), v)
            else:
                dst[key] = v

    for part in parts:
        merge(out, part)
    return out


def stage_of_path(plan: StagePlan, path: str) -> int:
    """The stage owning the tree path ``path`` (a parameter's, or a recipe
    layer's)."""
    for k, (lo, hi) in enumerate(plan.stages):
        if any(path == b or path.startswith(b + "/")
               for b in plan.block_names[lo:hi]):
            return k
    raise ValueError(f"{path!r} lies in no block of {plan.model_name}'s "
                     f"PP_BLOCKS")


def stage_model_psums(plan: StagePlan, tp_plan, k: int, *,
                      role: str) -> int:
    """The all-reduce-over-``model`` count stage ``k``'s ``role`` program
    shows: the per-stage slice of ``tp/plan.expected_collectives``.  A
    ``row`` layer sums once in the forward, a ``column`` layer once in the
    backward (the input gradient).  ``backward`` counts both (the JAX
    package's stage backward re-runs its forward); stage 0 differentiates
    with respect to its parameters only, so the stem's column input sum
    never runs.  The last stage's fused ``fwdbwd`` asks for the input
    gradient, so nothing is elided.  ``update`` has none."""
    if role not in ("forward", "backward", "fwdbwd", "update"):
        raise ValueError(f"unknown stage program role {role!r}")
    if tp_plan is None or role == "update":
        return 0
    lo, hi = plan.stages[k]
    names = plan.block_names[lo:hi]

    def under(layer: str) -> bool:
        return any(layer == b or layer.startswith(b + "/") for b in names)

    layers = [(p, s) for p, s in tp_plan.layers if under(p)]
    n_row = sum(1 for _, s in layers if s == "row")
    n_col = sum(1 for _, s in layers if s == "column")
    if role == "forward":
        return n_row
    if role == "fwdbwd":
        return n_row + n_col
    elide = (k == 0 and any(p == tp_plan.stem and s == "column"
                            for p, s in layers))
    return n_row + n_col - (1 if elide else 0)


def format_stage_table(plan: StagePlan,
                       num_micro: Optional[int] = None) -> str:
    """The stage plan as text: one row per stage (index, block range,
    per-stage summed forward MFLOPs/image, share of total), the balance
    line and, given the micro-batch count, the predicted-bubble line.  The
    first line is the schema anchor.  The JAX package's text."""
    header = (f"pipeline-stage plan: {plan.model_name} | "
              f"stage axis s={plan.num_stages}")
    cols = ("stage", "blocks", "fwd-mflop", "share")
    total = sum(plan.stage_costs) or 1.0
    body = []
    for k, (lo, hi) in enumerate(plan.stages):
        names = plan.block_names[lo:hi]
        span = (names[0] if len(names) == 1
                else f"{names[0]} .. {names[-1]}")
        cost = plan.stage_costs[k]
        cell = "-" if plan.uniform_costs else f"{cost / 1e6:.2f}"
        body.append((str(k), f"[{lo}:{hi}) {span}", cell,
                     f"{100.0 * cost / total:.1f}%"))
    widths = [max(len(r[i]) for r in [cols] + body)
              for i in range(len(cols))]
    lines = [header,
             "  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths))
              for r in body]
    imbalance = (max(plan.stage_costs) / (total / plan.num_stages)
                 if total else 1.0)
    lines.append(
        f"balance: max-stage/mean-stage = {imbalance:.3f}"
        + (" (uniform fallback: no cost table for this model)"
           if plan.uniform_costs else ""))
    if num_micro is not None:
        lines.append(
            f"predicted bubble: {predicted_bubble(plan.num_stages, num_micro):.3f}"
            f" at A={int(num_micro)} microbatches ((s-1)/(A+s-1))")
    return "\n".join(lines)
