"""The sharding planner: a model's declarative layer rules -> the split
dimension of each of its parameters (counterpart of
``ddp_tpu/parallel/tp/plan.py``).

A model opts in by declaring a ``TP_RECIPE``: an ordered mapping from
parameter-subtree path (``features/conv0``, the JAX package's tree paths)
to a parallel style, ``column`` (output dimension sharded) or ``row``
(input dimension sharded, output summed over the model group).
Back-to-back blocks pair column-then-row so no gather is needed between
them; everything unmatched (the row-parallel biases added after the sum,
BatchNorm's buffers) stays replicated.  The planner walks the model's
parameters, gives each leaf a spec, validates that every sharded dimension
divides by the model-axis size (all violations reported at once, by name),
and refuses rules that match nothing.

A spec is a tuple with one entry a dimension of the PORT's tensor:
``"model"`` on the split dimension, None elsewhere.  The port's layouts are
conv ``[out, in, kh, kw]`` and linear ``[out, in]``, so ``column`` splits
dim 0 and ``row`` dim 1 (a bias: dim 0 for ``column``, replicated for
``row``).  The JAX package's layouts are HWIO and ``[in, out]``, and its
specs split the last and the second-to-last dimension; ``tree_specs``
holds each leaf's spec in that layout (``interop.tree_dim``), which the
shard files' index records.

``format_plan_table`` is the table the CLI prints at start-up (without the
JAX table's ``fwd-mflop`` column, which needs the cost model of ROADMAP
A13c); ``expected_collectives`` is the model-axis all-reduce count a train
step or a forward must show (``parallel/dist.py::collective_calls``).
The auto-plan search's plan documents (``plan_from_doc``) are not ported
(ROADMAP A13c).
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..mesh import MODEL_AXIS

# Model registry name -> module name where it differs.
_MODULE_FOR = {"resnet18": "resnet", "tinylm": "transformer"}

STYLES = ("column", "row")
# Styles an EXPLICIT recipe (recipe_override's form) may assign per layer.
# "replicated" is the explicit no-sharding choice: matched leaves keep
# empty specs, but the layer still appears in ``plan.layers``.
RECIPE_STYLES = STYLES + ("replicated",)


class TPPlan(NamedTuple):
    """A resolved sharding plan for one (model, model-axis-size) pair."""
    model_name: str
    model_size: int
    param_specs: Dict[str, Tuple]   # tree path -> spec (port layout)
    stats_specs: Dict[str, Tuple]   # buffers: all replicated
    rows: Tuple       # ((path, style, shape, spec), ...) in table order
    # ((layer path, style), ...) in RECIPE (network) order.
    layers: Tuple = ()
    # The recipe's declared stem (the layer consuming the network input),
    # whose column-style input-gradient sum never runs in a train step.
    stem: Optional[str] = None
    # tree path -> spec in ddp_tpu's layout of the leaf.
    tree_specs: Optional[Dict[str, Tuple]] = None


class TPWiring(NamedTuple):
    """What a tensor-parallel forward needs: the model group and the
    recipe override (``None``: the model's own ``TP_RECIPE``)."""
    group: Any
    recipe: Optional[Dict[str, str]] = None


def forward_kwargs(tp: Optional[TPWiring]) -> Dict[str, Any]:
    """The model forward's tensor-parallel arguments (none without)."""
    return {} if tp is None else {"tp_group": tp.group,
                                  "tp_recipe": tp.recipe}


def _module(model_name: str):
    return importlib.import_module(
        f"ddp_tpu_torch.models.{_MODULE_FOR.get(model_name, model_name)}")


def _recipe_for(model_name: str):
    mod = _module(model_name)
    recipe = getattr(mod, "TP_RECIPE", None)
    if not recipe:
        raise ValueError(
            f"model {model_name!r} declares no TP_RECIPE; tensor "
            "parallelism needs the model to name its column/row-parallel "
            "layer pairs (see models/deepnn.py) — run it on a 1-D mesh, "
            "or add a recipe")
    bad = [s for s in recipe.values() if s not in STYLES]
    if bad:
        raise ValueError(f"unknown TP styles {bad} in {model_name}'s "
                         f"TP_RECIPE; expected one of {STYLES}")
    stem = getattr(mod, "TP_STEM", None)
    if stem is not None and stem not in recipe:
        raise ValueError(
            f"{model_name}'s TP_STEM {stem!r} is not a TP_RECIPE rule; "
            f"the stem must name one of {list(recipe)}")
    return recipe, stem


def _leaf_spec(style: str, ndim: int) -> Tuple:
    """The spec a ``column``/``row`` layer's leaf gets, by rank, in the
    port's layouts: the output dimension is first (conv ``[out, in, kh,
    kw]``, linear ``[out, in]``), the input dimension second.  Rank-1
    leaves are biases: sharded with the output for ``column``, replicated
    for ``row`` (added once, after the sum)."""
    if ndim == 1:
        return (MODEL_AXIS,) if style == "column" else ()
    entries = [None] * ndim
    entries[0 if style == "column" else 1] = MODEL_AXIS
    return tuple(entries)


def _param_leaves(model_name: str, params) -> List[Tuple[str, Any, Any]]:
    """``(tree path, shape, layout)`` of each parameter, sorted by path (the
    JAX package's walk order).  ``params`` is the port model (an
    ``nn.Module``) or its ``{name: tensor}`` parameters."""
    from ... import interop
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else dict(params))
    out = []
    for key, v in named.items():
        path, rule = interop.rule_of(model_name, key)
        out.append((path, tuple(int(s) for s in v.shape), rule.layout))
    return sorted(out)


def plan_for_model(model_name: str, params, batch_stats=None, *,
                   model_size: int, recipe=None, stem=None) -> TPPlan:
    """Resolve ``model_name``'s TP_RECIPE against the port model ``params``
    (an ``nn.Module``, or its named parameters; the meta device will do).

    ``recipe``/``stem`` override the model module's declarations with an
    explicit per-layer mapping, under the same validation; an override may
    also assign ``"replicated"`` (RECIPE_STYLES).

    Raises ``ValueError`` when the model has no recipe, a rule matches no
    parameter subtree, or any sharded dimension does not divide by
    ``model_size`` — every violation in one message, by leaf path."""
    from ... import interop
    if model_size < 1:
        raise ValueError(f"model_size must be >= 1, got {model_size}")
    if recipe is None:
        recipe, stem = _recipe_for(model_name)
    else:
        recipe = dict(recipe)
        bad = [s for s in recipe.values() if s not in RECIPE_STYLES]
        if bad:
            raise ValueError(
                f"unknown TP styles {bad} in explicit recipe for "
                f"{model_name!r}; expected one of {RECIPE_STYLES}")
        if stem is not None and stem not in recipe:
            raise ValueError(
                f"explicit stem {stem!r} is not a recipe rule; the stem "
                f"must name one of {list(recipe)}")
        # Network order: the module's declared order first.
        declared = tuple(getattr(_module(model_name), "TP_RECIPE", None)
                         or ())
        recipe = {**{k: recipe[k] for k in declared if k in recipe},
                  **{k: v for k, v in recipe.items() if k not in declared}}
    matched = set()
    rows, errors = [], []
    specs: Dict[str, Tuple] = {}
    tree_specs: Dict[str, Tuple] = {}
    for path, shape, layout in _param_leaves(model_name, params):
        style = None
        for prefix, s in recipe.items():
            if path == prefix or path.startswith(prefix + "/"):
                style, _ = s, matched.add(prefix)
                break
        spec = (() if style in (None, "replicated")
                else _leaf_spec(style, len(shape)))
        for dim, name in enumerate(spec):
            if name == MODEL_AXIS and shape[dim] % model_size:
                errors.append(
                    f"  {path}: dim {dim} extent {shape[dim]} not "
                    f"divisible by model axis size {model_size}")
        rows.append((path, style or "replicated", shape, spec))
        specs[path] = spec
        tree = [None] * len(shape)
        for dim, name in enumerate(spec):
            if name is not None:
                tree[interop.tree_dim(layout, dim)] = name
        tree_specs[path] = tuple(tree) if spec else ()
    unmatched = [p for p in recipe if p not in matched]
    if unmatched:
        raise ValueError(
            f"TP_RECIPE rules {unmatched} match no parameter of "
            f"{model_name!r} — the recipe and the model have drifted")
    if errors:
        raise ValueError(
            f"tensor-parallel plan for {model_name!r} is infeasible at "
            f"model axis size {model_size}:\n" + "\n".join(errors))
    stats_specs = {k: () for k in (batch_stats or {})}
    return TPPlan(model_name, model_size, specs, stats_specs, tuple(rows),
                  layers=tuple(recipe.items()), stem=stem,
                  tree_specs=tree_specs)


def local_param_count(plan: TPPlan) -> int:
    """Per-model-shard parameter count (sharded leaves contribute 1/m) —
    the flat-vector length the sharded update pads and slices
    (train/zero.py)."""
    n = 0
    for _path, _style, shape, spec in plan.rows:
        size = int(np.prod(shape)) if shape else 1
        if any(e == MODEL_AXIS for e in spec):
            size //= plan.model_size
        n += size
    return n


def expected_collectives(plan: TPPlan, *, backward: bool) -> Dict[str, int]:
    """The model-axis all-reduce budget this plan implies.

    Per layer (parallel/tp/layers.py, Megatron's f/g pair): a ``row``
    layer contributes ONE forward all-reduce over the model group (the
    partial-sum reduction in row_linear/row_conv2d); a ``column`` layer
    contributes ONE backward all-reduce (``column_input``'s backward,
    reducing the input gradient that row-sharding the next layer leaves
    partial).  A train step takes gradients w.r.t. the parameters only, so
    the STEM column layer's input-gradient sum never runs (its input, the
    batch, needs no gradient; autograd does not call that backward).

    Returns ``{"psum_model_fwd", "psum_model_bwd", "psum_model",
    "elided_stem_psum"}`` where ``psum_model`` is fwd (+ bwd when
    ``backward=True``): a forward (eval, serving) shows ``backward=False``'s
    count, a train step ``backward=True``'s."""
    n_row = sum(1 for _, s in plan.layers if s == "row")
    n_col = sum(1 for _, s in plan.layers if s == "column")
    stem_is_column = any(p == plan.stem and s == "column"
                         for p, s in plan.layers)
    elided = 1 if (backward and stem_is_column) else 0
    bwd = (n_col - elided) if backward else 0
    return {"psum_model_fwd": n_row, "psum_model_bwd": bwd,
            "psum_model": n_row + bwd, "elided_stem_psum": elided}


def expected_collectives_by_layer(plan: TPPlan, *,
                                  backward: bool) -> Dict[str, Dict[str, int]]:
    """The per-layer unit table behind :func:`expected_collectives`: an
    ordered ``{layer path: {"fwd": n, "bwd": n}}`` mapping in recipe
    (network) order.  Each ``row`` layer contributes one forward sum, each
    ``column`` layer one backward sum (``backward=True`` only), the
    declared stem's backward sum is elided; the totals are
    ``expected_collectives``'."""
    table: Dict[str, Dict[str, int]] = {}
    for path, style in plan.layers:
        fwd = 1 if style == "row" else 0
        bwd = (1 if (backward and style == "column"
                     and path != plan.stem) else 0)
        table[path] = {"fwd": fwd, "bwd": bwd}
    return table


def format_collective_table(plan: TPPlan, *, backward: bool) -> str:
    """One line per recipe layer (``path style fwd+bwd``) plus the
    totals: the named breakdown of :func:`expected_collectives`."""
    table = expected_collectives_by_layer(plan, backward=backward)
    styles = dict(plan.layers)
    lines = []
    for path, counts in table.items():
        note = (" (stem: bwd psum elided)"
                if (backward and path == plan.stem
                    and styles.get(path) == "column") else "")
        lines.append(f"    {path} [{styles[path]}]: fwd={counts['fwd']} "
                     f"bwd={counts['bwd']}{note}")
    exp = expected_collectives(plan, backward=backward)
    lines.append(f"    total: fwd={exp['psum_model_fwd']} "
                 f"bwd={exp['psum_model_bwd']} = {exp['psum_model']}")
    return "\n".join(lines)


def is_trivial(plan: TPPlan) -> bool:
    """True when the plan shards nothing (no column/row layer): the
    program it implies is exactly the 1-D data-parallel one, which the
    step wiring then runs."""
    return all(s not in STYLES for _, s in plan.layers)


def recipe_override(plan: TPPlan):
    """The ``tp_recipe`` argument this plan implies for the model's
    forward: ``None`` when the plan IS the model module's own
    TP_RECIPE/TP_STEM (the forward's default), the explicit per-layer
    mapping otherwise."""
    try:
        recipe, stem = _recipe_for(plan.model_name)
    except ValueError:
        return dict(plan.layers)
    if dict(plan.layers) == dict(recipe) and plan.stem == stem:
        return None
    return dict(plan.layers)


def wiring(plan: Optional[TPPlan], group) -> Optional[TPWiring]:
    """The step wiring's tensor-parallel arguments: None (the plain
    data-parallel path) without a plan, for a trivial plan or at a model
    axis of 1; else the model ``group`` and the recipe override."""
    if plan is None or is_trivial(plan) or plan.model_size == 1:
        return None
    return TPWiring(group, recipe_override(plan))


def shard_module_(model, plan: TPPlan, model_index: int) -> None:
    """Cut ``model``'s parameters, in place, to model index
    ``model_index``'s slices under ``plan`` (``interop.shard_state``)."""
    from ... import interop
    import torch
    named = dict(model.named_parameters())
    sliced = interop.shard_state(plan, {k: p.detach()
                                        for k, p in named.items()},
                                 model_index)
    with torch.no_grad():
        for k, p in named.items():
            p.data = sliced[k].contiguous()


def _spec_str(spec: Tuple) -> str:
    return f"PartitionSpec({', '.join(repr(e) for e in spec)})"


_STYLE_COLLECTIVE = {"column": "psum(model)@bwd", "row": "psum(model)@fwd",
                     "replicated": "-"}


def format_plan_table(plan: TPPlan) -> str:
    """The human-readable plan: one row per leaf (path, style, shape,
    spec, per-shard shape, the layer's model-axis collective), then the
    totals line and the expected-collectives line.  Shapes and specs are
    the port's layouts; the rest of the text is the JAX package's table
    without its cost column."""
    header = (f"tensor-parallel plan: {plan.model_name} | "
              f"model axis m={plan.model_size}")
    cols = ("leaf", "style", "shape", "spec", "per-shard", "collectives")
    body = []
    total = sharded = 0
    for path, style, shape, spec in plan.rows:
        local = tuple(s // plan.model_size if e == MODEL_AXIS else s
                      for s, e in zip(shape,
                                      tuple(spec) + (None,) * len(shape)))
        size = int(np.prod(shape)) if shape else 1
        total += size
        if any(e == MODEL_AXIS for e in spec):
            sharded += size
        body.append((path, style, str(shape), _spec_str(spec), str(local),
                     _STYLE_COLLECTIVE[style]))
    widths = [max(len(c), *(len(r[i]) for r in body))
              for i, c in enumerate(cols)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [header, fmt.format(*cols)]
    lines += [fmt.format(*row) for row in body]
    pct = 100.0 * sharded / max(total, 1)
    lines.append(f"total {total:,} params | sharded {sharded:,} "
                 f"({pct:.2f}%) | replicated {total - sharded:,}")
    exp = expected_collectives(plan, backward=True)
    elision = (f" (stem {plan.stem}: input-grad psum elided)"
               if exp["elided_stem_psum"] else "")
    lines.append(f"expected collectives: psum(model) "
                 f"fwd={exp['psum_model_fwd']} bwd={exp['psum_model_bwd']} "
                 f"train={exp['psum_model']}{elision}")
    return "\n".join(lines)
