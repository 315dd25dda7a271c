"""The generative-LM training path (counterpart of ``ddp_tpu/train/lm.py``):
next-token cross-entropy over ``[B, T]`` token batches of the byte LM
``tinylm`` (``models/transformer.py``), the classifier step's skeleton.

``tokens[:, :-1]`` predicts ``tokens[:, 1:]``; every position is a target.
Each rank trains on its data shard of the batch (the batch is replicated
over the model axis), and the two objectives are the JAX package's:

- without a tensor-parallel plan, the GLOBAL mean ``psum(ce_sum) /
  psum(count)``: the rank differentiates ``ce_sum / total_count``, the
  count summed over the data group first, and the gradients are summed
  over the data group;
- under a plan (``--mesh_shape D,M``, M > 1), the local objective
  ``ce_sum / (count * D)`` through the model's tensor-parallel forward
  (its row sums carry identity backwards, ``parallel/tp/layers.py``), the
  gradients then summed over the data group only.

Both report the global-mean loss.  The update is SGD with momentum 0.9,
no weight decay and the constant ``--lr``.  The synthetic corpus
(:func:`synthetic_tokens`) is the JAX package's, bit for bit: affine
sequences ``t_{k+1} = (31 t_k + 7) mod 256`` from seeded start tokens, a
next token the model can learn exactly, so the loss's descent is real.

``train_lm`` writes its final state through ``save_checkpoint`` (the
gathered v1 file, which the JAX engine reads too; a tensor-parallel run
gathers its slices over the model group first) and
``CheckpointLineage.commit``, so the serving engines' lineage walk
restores it on any layout.

CLI::

    python -m ddp_tpu_torch.train.lm --steps 30 --snapshot_path lm/ck.npz
    python -m ddp_tpu_torch.train.lm --mesh_shape 1,2 --device cpu

``--mesh_shape D,M`` (or ``--num_devices N``, a data axis of N) spawns
``D*M`` ranks on this machine (``parallel/dist.py::launch_local``) laid out
by ``parallel/dist.py::init_mesh``: one rank a card over NCCL when the
cards suffice, else gloo ranks that share card 0 (gloo is the only backend
that runs two ranks on one card), and gloo ranks with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, dtype_name, resolve_device, set_tf32
from ..ops.losses import cross_entropy_sum_count
from ..optim import sgd as sgd_lib
from ..parallel import dist
from ..parallel.tp.plan import TPWiring, forward_kwargs
from .step import TrainState, init_train_state

CORPUS_A = 31          # multiplier of the affine next-token map
CORPUS_C = 7           # increment


def synthetic_tokens(n_seqs: int, seq_len: int, *, vocab: int,
                     seed: int = 0) -> np.ndarray:
    """``int32[n_seqs, seq_len]`` of affine sequences ``t_{k+1} = (31 t_k +
    7) mod vocab`` from seeded uniform start tokens: the JAX package's
    corpus, bit for bit (the same numpy draws)."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((n_seqs, seq_len), np.int32)
    toks[:, 0] = rng.randint(0, vocab, size=n_seqs)
    for k in range(1, seq_len):
        toks[:, k] = (CORPUS_A * toks[:, k - 1] + CORPUS_C) % vocab
    return toks


def make_lm_step(model, sgd_config: sgd_lib.SGDConfig, lr: float, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 tp: Optional[TPWiring] = None):
    """``step(state, tokens) -> loss``: one optimizer step of ``model`` on
    this rank's token shard ``tokens`` (``[b, T]`` on the model's device),
    updating ``state`` in place; ``loss`` is the global-mean loss (a
    device scalar).  One all-reduce of ``(ce_sum, count)`` and one of the
    gradients, both over the data group (none without a process group);
    ``tp`` runs the tensor-parallel forward and its local objective.
    Build it after the process group and the mesh exist."""
    params = list(model.parameters())
    d = dist.data_size()
    tp_kwargs = forward_kwargs(tp)

    def step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        model.train()
        logits = model.lm_forward(tokens[:, :-1],
                                  compute_dtype=compute_dtype, **tp_kwargs)
        ce_sum, count = cross_entropy_sum_count(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        sums = dist.all_reduce_sum_(torch.stack([ce_sum.detach(), count]),
                                    "lm_loss")
        objective = (ce_sum / sums[1] if tp is None
                     else ce_sum / (count * d))
        grads = dist.all_reduce_grads(torch.autograd.grad(objective,
                                                          params))
        sgd_lib.apply_updates(params, list(grads), state.momentum, lr,
                              sgd_config)
        state.step += 1
        return sums[0] / sums[1]

    return step


def _log(msg: str) -> None:
    if dist.rank() == 0:
        print(msg, flush=True)


def train_lm(*, steps: int, batch: int, seq_len: int,
             device: DeviceLike = "cuda", lr: float = 0.1, seed: int = 0,
             compute_dtype: Optional[torch.dtype] = None, plan=None,
             snapshot_path: Optional[str] = None, log_every: int = 10,
             quiet: bool = False, model=None
             ) -> Tuple[TrainState, List[float]]:
    """The whole LM training loop on this rank; returns ``(state,
    losses)``, the per-step losses as floats.  ``model`` is the start (a
    whole ``tinylm``; a fresh one from ``seed`` when None); under ``plan``
    (a tensor-parallel plan of the run's mesh) this rank keeps its slices
    of it.  ``snapshot_path`` writes the final state through
    ``save_checkpoint`` + ``CheckpointLineage.commit`` (rank 0 writes; a
    collective under a plan)."""
    from ..models import get_model
    from ..models import transformer as tfm
    from ..parallel.tp.plan import shard_module_, wiring

    device = resolve_device(device)
    if seq_len > tfm.T_MAX:
        raise ValueError(f"seq_len {seq_len} exceeds T_MAX {tfm.T_MAX}")
    d = dist.data_size()
    if batch % d:
        raise ValueError(f"batch {batch} not divisible by data axis {d}")
    if model is None:
        model = get_model(tfm.LM_NAME,
                          generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    mesh = dist.mesh()
    if plan is not None and plan.model_size > 1:
        shard_module_(model, plan, mesh.model_index if mesh else 0)
    state = init_train_state(model)
    tp = wiring(plan, dist.model_group())
    step_fn = make_lm_step(
        model, sgd_lib.SGDConfig(lr=lr, momentum=0.9, weight_decay=0.0), lr,
        compute_dtype=compute_dtype, tp=tp)

    corpus = synthetic_tokens(max(batch * 8, batch), seq_len,
                              vocab=tfm.VOCAB, seed=seed)
    local = batch // d
    row = dist.data_rank() * local
    # The losses stay on the device and are read once after the loop; a
    # logged step reads its own.
    step_losses: List[torch.Tensor] = []
    for i in range(steps):
        lo = (i * batch) % corpus.shape[0]
        shard = corpus[lo:lo + batch][row:row + local]
        tokens = torch.from_numpy(shard.astype(np.int64)).to(device)
        loss = step_fn(state, tokens)
        step_losses.append(loss)
        if not quiet and (i % log_every == 0 or i == steps - 1):
            # analysis: host-sync-ok(a logged step only, one in log_every)
            _log(f"[lm] step {i:4d}  loss {float(loss):.4f}")
    losses = torch.stack(step_losses).tolist() if step_losses else []

    if snapshot_path:
        save_lm(snapshot_path, state, plan, quiet=quiet)
    return state, losses


def save_lm(snapshot_path: str, state: TrainState, plan=None, *,
            quiet: bool = False) -> Optional[str]:
    """Write ``state`` as the v1 file at ``snapshot_path`` and commit it to
    the lineage (epoch 0); returns the sha256 on rank 0, None elsewhere.
    Under ``plan`` every rank joins the model group's gather first."""
    from ..resilience.lineage import CheckpointLineage
    from ..train import checkpoint as ckpt_lib
    from ..train.trainer import tp_full_state
    model = state.model
    sd, mom = tp_full_state(model, state.momentum,
                            plan if plan is not None
                            and plan.model_size > 1 else None)
    if dist.rank() != 0:
        return None
    os.makedirs(os.path.dirname(snapshot_path) or ".", exist_ok=True)
    sha = ckpt_lib.write_gathered(
        snapshot_path, ckpt_lib.state_arrays(model.name, sd, mom),
        state.step, 0)
    CheckpointLineage(snapshot_path).commit(epoch=0, step=state.step,
                                            sha256=sha)
    if not quiet:
        _log(f"[lm] wrote {snapshot_path} (sha256 {sha[:12]}...)")
    return sha


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.train.lm",
        description="Train the tiny decoder-only LM (models/transformer.py"
                    ":TinyLM.lm_forward) on the deterministic synthetic "
                    "corpus.")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_shape", type=str, default=None,
                   help="D or D,M — 2-D runs tensor-parallel attention "
                        "per the transformer TP_RECIPE")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--snapshot_path", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda is an "
                        "error")
    p.add_argument("--result_json", default=None, metavar="PATH",
                   help="Rank 0 writes the losses, the seconds and the run's "
                        "shape here")
    # Set by the spawner for its ranks: the process group's backend.
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    return p


def _mesh_dims(args) -> Tuple[int, ...]:
    if args.mesh_shape:
        try:
            dims = tuple(int(v) for v in
                         args.mesh_shape.replace("x", ",").split(","))
        except ValueError:
            dims = ()
        if not 1 <= len(dims) <= 2 or min(dims) < 1:
            raise SystemExit(f"--mesh_shape wants D or D,M (got "
                             f"{args.mesh_shape!r})")
        if args.num_devices and args.num_devices != int(np.prod(dims)):
            raise SystemExit(f"--num_devices {args.num_devices} contradicts "
                             f"--mesh_shape {args.mesh_shape}")
        return dims
    return (args.num_devices or 1,)


def _spawn(argv: List[str], n: int, device: torch.device) -> int:
    """Run this CLI as ``n`` local ranks; returns their largest exit code.
    On the card: NCCL one a card when ``n`` cards are visible, else gloo
    ranks sharing card 0."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    same = device.type == "cuda" and n > cards
    backend = "nccl" if device.type == "cuda" and not same else "gloo"
    return dist.launch_local(
        [sys.executable, "-m", "ddp_tpu_torch.train.lm", *argv,
         "--backend", backend], n, same_device=same)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dims = _mesh_dims(args)
    n = int(np.prod(dims))
    if n > 1 and not dist.in_rendezvous():
        return _spawn(argv, n, device)
    set_tf32(False)
    # A rank of a spawned run joins its group; world 1 makes none, so an
    # embedding process's own group (if any) is left alone.
    ranked = dist.in_rendezvous()
    if ranked:
        device = dist.initialize(device, args.backend)
    try:
        from ..parallel.mesh import Mesh
        if dist.world_size() != n:
            raise SystemExit(f"--mesh_shape/--num_devices ask for {n} "
                             f"ranks; this run's world is "
                             f"{dist.world_size()}")
        dist.init_mesh(Mesh(dims, dist.rank()))
        plan = None
        if len(dims) == 2 and dims[1] > 1:
            from ..models import get_model
            from ..parallel.tp.plan import format_plan_table, plan_for_model
            plan = plan_for_model("tinylm", get_model("tinylm",
                                                      device="meta"),
                                  model_size=dims[1])
            _log(format_plan_table(plan))
        t0 = time.perf_counter()
        _, losses = train_lm(
            steps=args.steps, batch=args.batch, seq_len=args.seq_len,
            device=device, lr=args.lr, seed=args.seed,
            compute_dtype=torch.bfloat16 if args.bf16 else None, plan=plan,
            snapshot_path=args.snapshot_path)
        dt = time.perf_counter() - t0
        _log(f"[lm] {args.steps} steps in {dt:.1f}s  "
             f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if args.result_json and dist.rank() == 0:
            with open(args.result_json, "w") as f:
                json.dump({"losses": losses, "seconds": dt,
                           "steps": args.steps, "mesh_shape": list(dims),
                           "world": dist.world_size(),
                           "backend": dist.backend(),
                           "device": str(device),
                           "compute_dtype": dtype_name(
                               torch.bfloat16 if args.bf16 else None),
                           "collectives": dict(dist.collective_calls)}, f)
        return 0
    finally:
        dist.clear_mesh()
        if ranked:
            dist.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
