"""The transformer workloads (counterpart of
``ddp_tpu/models/transformer.py``): a CIFAR patch encoder and a byte-level
decoder LM that share one block stack and one parameter layout.

- :class:`Transformer` (``transformer``): a small vision transformer over
  4x4 CIFAR patches (64 tokens of 48 values -> ``D_MODEL``), mean-pooled
  into the 10-way head.  It takes the channels-first float batch every
  port model takes (``gather_batch``'s output), and cuts it into patches
  whose vector order is the JAX model's ``(ph, pw, c)``.
- :class:`TinyLM` (``tinylm``): a decoder-only byte LM (``VOCAB`` 256,
  causal blocks).  Besides the full-sequence :meth:`TinyLM.lm_forward` it
  has the incremental pair the KV-cache engine runs
  (``serve/kvcache.py``): :meth:`TinyLM.prefill`, which also returns the
  ``[L, B, T, h, hd]`` key/value stacks, and :meth:`TinyLM.decode_step`,
  which writes each slot's key/value into the cache IN PLACE at its
  position and attends over the slot's valid prefix.

Each block is pre-LN attention and an MLP, written as the JAX model writes
it, and these details are its, not ``torch.nn``'s defaults: LayerNorm takes
its statistics in float32 with ``eps = 1e-6`` inside the rsqrt; the MLP's
GELU is the tanh form (``jax.nn.gelu``'s default); the attention mask fills
with ``-0.7 * finfo(float32).max``, not ``-inf``; attention is two matrix
products around a float32 softmax.  A linear's weight is ``[out, in]``
(the JAX package stores ``[in, out]``; ``interop.py`` transposes).  The
fused QKV layer's output features are head-major, ``(head, {q,k,v},
dim)``, so a contiguous block of them is whole heads with their q, k and
v.  Under ``--bf16`` the blocks compute in the compute dtype, with float32
softmax and LayerNorm statistics, and the logits are float32.

Tensor parallelism (``parallel/tp/``): one ``TP_RECIPE`` serves both
models (the JAX model's): the fused QKV and ``fc1`` column-parallel,
``out`` and ``fc2`` row-parallel, so attention runs on the rank's own
heads with no communication, and a block shows one forward and one
backward all-reduce over the model group for each pair.  LayerNorms,
embeddings and the head stay replicated.  Under a model group the
parameters are this rank's slices and the recipe's members run through
``parallel/tp/layers.py``'s column/row wrappers.

Pipeline parallelism: ``PP_BLOCKS`` is embed, one entry a block, then
head; every block hands over the full-width ``[B, T, d]`` stream, so
``PP_SHARDED_OUT`` is empty.  :meth:`Transformer.forward_blocks` runs a
contiguous range of them, and :meth:`Transformer.forward` is that range
over every block.

Weights are drawn from an explicit CPU ``generator`` (seed 0 when omitted)
with the JAX model's distributions: PyTorch's linear defaults for every
linear, ``0.02 * N(0, 1)`` for the positional and token tables, ones and
zeros for LayerNorm.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import initializers as init_lib
from ..ops.layers import linear
from .modules import Linear

NAME = "transformer"
LM_NAME = "tinylm"
NUM_CLASSES = 10

PATCH = 4                       # 4x4 patches -> 64 tokens of 48 values
TOKENS = (32 // PATCH) ** 2     # 64
PATCH_DIM = PATCH * PATCH * 3   # 48
D_MODEL = 64
N_HEADS = 4
HEAD_DIM = D_MODEL // N_HEADS   # 16
N_LAYERS = 2
MLP_HIDDEN = 4 * D_MODEL        # 256

VOCAB = 256                     # byte-level
T_MAX = 128                     # positional table / KV-cache depth bound

TP_RECIPE = {}
for _i in range(N_LAYERS):
    TP_RECIPE[f"blocks/block{_i}/attn/qkv"] = "column"
    TP_RECIPE[f"blocks/block{_i}/attn/out"] = "row"
    TP_RECIPE[f"blocks/block{_i}/mlp/fc1"] = "column"
    TP_RECIPE[f"blocks/block{_i}/mlp/fc2"] = "row"
del _i

# No barrier layers: every row output is full-width and the residual
# stream never crosses a sharded reshape.
TP_BARRIERS = ()

# The network input feeds the replicated embedding, not a column layer, so
# every column layer's input-gradient sum runs in a train step.
TP_STEM = None

PP_BLOCKS = ("embed",) + tuple(
    f"blocks/block{i}" for i in range(N_LAYERS)) + ("head",)
PP_SHARDED_OUT = ()

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _linear_module(generator: torch.Generator, fan_in: int, fan_out: int,
                   device) -> Linear:
    return Linear(init_lib.linear_weight(generator, fan_in, fan_out, device),
                  init_lib.linear_bias(generator, fan_in, fan_out, device))


def _table(generator: torch.Generator, rows: int, device) -> nn.Parameter:
    t = torch.empty((rows, D_MODEL), dtype=torch.float32)
    t.normal_(0.0, 1.0, generator=generator)
    return nn.Parameter((0.02 * t).to(device))


class LayerNorm(nn.Module):
    """The JAX model's LayerNorm: ``weight`` (its ``scale``) ones, ``bias``
    zeros; see :func:`layer_norm`."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(D_MODEL, device=device))
        self.bias = nn.Parameter(torch.zeros(D_MODEL, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics and ``eps =
    1e-6`` inside the rsqrt, the result in ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    return (y * weight.float() + bias.float()).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        self.qkv = _linear_module(generator, D_MODEL, 3 * D_MODEL, device)
        self.out = _linear_module(generator, D_MODEL, D_MODEL, device)


class MLP(nn.Module):
    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        self.fc1 = _linear_module(generator, D_MODEL, MLP_HIDDEN, device)
        self.fc2 = _linear_module(generator, MLP_HIDDEN, D_MODEL, device)


class Block(nn.Module):
    """One pre-LN block's parameters (tree path ``blocks/blockN``)."""

    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        self.ln1 = LayerNorm(device)
        self.attn = Attention(generator, device)
        self.ln2 = LayerNorm(device)
        self.mlp = MLP(generator, device)


class Head(nn.Module):
    def __init__(self, generator: torch.Generator, out: int, device=None):
        super().__init__()
        self.ln = LayerNorm(device)
        self.linear = _linear_module(generator, D_MODEL, out, device)


class PatchEmbed(nn.Module):
    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        self.patch = _linear_module(generator, PATCH_DIM, D_MODEL, device)
        self.pos = _table(generator, TOKENS, device)


class TokenEmbed(nn.Module):
    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        self.tok = _table(generator, VOCAB, device)
        self.pos = _table(generator, T_MAX, device)


# ---------------------------------------------------------------------------
# the shared forward pieces


class _Wiring:
    """A forward's tensor-parallel arguments: the model group (None: the
    plain path) and the recipe it follows."""

    def __init__(self, tp_group, tp_recipe: Optional[Dict[str, str]]):
        self.group = tp_group
        self.recipe = TP_RECIPE if tp_recipe is None else tp_recipe

    def style(self, path: str) -> str:
        if self.group is None:
            return "replicated"
        return self.recipe.get(path, "replicated")


def _proj(x: torch.Tensor, layer: Linear, path: str, wiring: _Wiring,
          cd: torch.dtype) -> torch.Tensor:
    w, b = layer.weight.to(cd), layer.bias.to(cd)
    style = wiring.style(path)
    if style == "replicated":
        return linear(x, w, b)
    from ..parallel.tp import layers as tp
    fn = tp.column_linear if style == "column" else tp.row_linear
    return fn(x, w, b, wiring.group)


def split_heads(qkv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[..., 3*h*hd]`` head-major -> (q, k, v), each ``[..., h, hd]``;
    ``h`` is whatever the width holds (a rank's own heads under a model
    group)."""
    *lead, width = qkv.shape
    h = width // (3 * HEAD_DIM)
    qkv = qkv.reshape(*lead, h, 3, HEAD_DIM)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``[B,Tq,h,hd] x [B,Tk,h,hd] -> [B,Tq,h,hd]``: the scores in the
    compute dtype, then scaled and softmaxed in float32 with the mask
    filled with ``_NEG_INF`` first, the weights back in the compute dtype.
    Two matrix products, as the JAX model's two einsums."""
    scale = 1.0 / float(HEAD_DIM) ** 0.5
    qh = q.permute(0, 2, 1, 3)                  # [B,h,Tq,hd]
    kh = k.permute(0, 2, 3, 1)                  # [B,h,hd,Tk]
    scores = torch.matmul(qh, kh).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(w, v.permute(0, 2, 1, 3))  # [B,h,Tq,hd]
    return out.permute(0, 2, 1, 3)


def _mlp(x: torch.Tensor, blk: Block, path: str, wiring: _Wiring,
         cd: torch.dtype) -> torch.Tensor:
    h = _proj(x, blk.mlp.fc1, f"{path}/mlp/fc1", wiring, cd)
    h = F.gelu(h, approximate="tanh")
    return _proj(h, blk.mlp.fc2, f"{path}/mlp/fc2", wiring, cd)


def _block_forward(blk: Block, path: str, x: torch.Tensor, *, causal: bool,
                   wiring: _Wiring, cd: torch.dtype
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """One block over the whole sequence: the new residual stream and the
    block's ``(k, v)`` (``[B, T, h_local, hd]``), which prefill keeps."""
    h = blk.ln1(x)
    q, k, v = split_heads(_proj(h, blk.attn.qkv, f"{path}/attn/qkv",
                                wiring, cd))
    mask = None
    if causal:
        t = x.shape[-2]
        idx = torch.arange(t, device=x.device)
        mask = (idx[None, :] <= idx[:, None])[None, None]
    a = attention(q, k, v, mask)
    a = a.reshape(*a.shape[:-2], -1)  # [B,T,h,hd] -> [B,T,h*hd]
    x = x + _proj(a, blk.attn.out, f"{path}/attn/out", wiring, cd)
    x = x + _mlp(blk.ln2(x), blk, path, wiring, cd)
    return x, (k, v)


def patchify(x: torch.Tensor) -> torch.Tensor:
    """``[B,3,32,32]`` channels-first -> ``[B, 64, 48]`` of 4x4 patches in
    row-major patch order, each patch's vector in the JAX model's ``(ph,
    pw, c)`` order (it cuts NHWC)."""
    b = x.shape[0]
    g = 32 // PATCH
    x = x.reshape(b, 3, g, PATCH, g, PATCH)
    x = x.permute(0, 2, 4, 3, 5, 1)  # (b, gy, gx, ph, pw, c)
    return x.reshape(b, TOKENS, PATCH_DIM)


def _head(x: torch.Tensor, head: Head, cd: torch.dtype) -> torch.Tensor:
    x = head.ln(x)
    return linear(x, head.linear.weight.to(cd), head.linear.bias.to(cd))


class _Stack(nn.Module):
    """What both models share: the blocks (tree paths ``blocks/blockN``)."""

    def _init_blocks(self, generator: torch.Generator, device) -> None:
        self.blocks = nn.ModuleList(Block(generator, device)
                                    for _ in range(N_LAYERS))


# ---------------------------------------------------------------------------
# the CIFAR encoder


class Transformer(_Stack):
    """``[N,3,32,32]`` float -> ``[N,10]`` float32 logits; the port model's
    forward signature (no BatchNorm, no dropout: ``sync_bn`` and
    ``generator`` change nothing)."""

    name = NAME

    def __init__(self, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.embed = PatchEmbed(generator, device)
        self._init_blocks(generator, device)
        self.head = Head(generator, NUM_CLASSES, device)

    def forward(self, x: torch.Tensor, sync_bn: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                tp_group=None, tp_recipe: Optional[Dict[str, str]] = None
                ) -> torch.Tensor:
        """The logits: :meth:`forward_blocks` over every block.  With
        ``tp_group`` the recipe's members run tensor-parallel."""
        return self.forward_blocks(x, (0, len(PP_BLOCKS)),
                                   compute_dtype=compute_dtype,
                                   tp_group=tp_group, tp_recipe=tp_recipe)

    def forward_blocks(self, x: torch.Tensor, blocks: Tuple[int, int], *,
                       compute_dtype: Optional[torch.dtype] = None,
                       generator: Optional[torch.Generator] = None,
                       tp_group=None,
                       tp_recipe: Optional[Dict[str, str]] = None
                       ) -> torch.Tensor:
        """The ``PP_BLOCKS`` half-open range ``blocks=(lo, hi)`` (the JAX
        model's ``apply_blocks``): ``x`` is the image batch for ``lo ==
        0``, else the ``[B, T, d]`` residual stream of the previous stage;
        after the last block the float32 logits."""
        lo, hi = blocks
        if not 0 <= lo < hi <= len(PP_BLOCKS):
            raise ValueError(
                f"blocks must be a non-empty range within "
                f"(0, {len(PP_BLOCKS)}), got {blocks!r}")
        wiring = _Wiring(tp_group, tp_recipe)
        cd = compute_dtype or x.dtype
        x = x.to(cd)
        for name in PP_BLOCKS[lo:hi]:
            if name == "embed":
                e = self.embed
                x = linear(patchify(x), e.patch.weight.to(cd),
                           e.patch.bias.to(cd))
                x = x + e.pos.to(cd)[None, :, :]
            elif name == "head":
                h = self.head
                x = h.ln(x).mean(dim=-2)  # mean-pool tokens
                x = linear(x, h.linear.weight.to(cd),
                           h.linear.bias.to(cd)).float()
            else:
                i = int(name.rsplit("block", 1)[1])
                x, _ = _block_forward(self.blocks[i], name, x, causal=False,
                                      wiring=wiring, cd=cd)
        return x


# ---------------------------------------------------------------------------
# the decoder-only LM


class TinyLM(_Stack):
    """The byte LM.  :meth:`forward` is :meth:`lm_forward` (int tokens
    ``[B, T]`` -> float32 logits ``[B, T, VOCAB]``)."""

    name = LM_NAME
    # A token model: its batches are [B, T] token ids, not images.
    workload = "lm"

    def __init__(self, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.embed = TokenEmbed(generator, device)
        self._init_blocks(generator, device)
        self.head = Head(generator, VOCAB, device)

    def forward(self, tokens: torch.Tensor, sync_bn: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                tp_group=None, tp_recipe: Optional[Dict[str, str]] = None
                ) -> torch.Tensor:
        return self.lm_forward(tokens, compute_dtype=compute_dtype,
                               tp_group=tp_group, tp_recipe=tp_recipe)

    def _embed(self, tokens: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        e = self.embed
        t = tokens.shape[-1]
        return e.tok.to(cd)[tokens.long()] + e.pos.to(cd)[None, :t, :]

    def _run(self, tokens: torch.Tensor, cd: torch.dtype, wiring: _Wiring
             ) -> Tuple[torch.Tensor, List[torch.Tensor],
                        List[torch.Tensor]]:
        x = self._embed(tokens, cd)
        ks, vs = [], []
        for i, blk in enumerate(self.blocks):
            x, (k, v) = _block_forward(blk, f"blocks/block{i}", x,
                                       causal=True, wiring=wiring, cd=cd)
            ks.append(k)
            vs.append(v)
        return _head(x, self.head, cd).float(), ks, vs

    def lm_forward(self, tokens: torch.Tensor, *,
                   compute_dtype: Optional[torch.dtype] = None,
                   tp_group=None,
                   tp_recipe: Optional[Dict[str, str]] = None
                   ) -> torch.Tensor:
        """The full-sequence causal forward: ``[B, T]`` tokens -> float32
        logits ``[B, T, VOCAB]``; the uncached reference the cached decode
        is held against."""
        if tokens.shape[-1] > T_MAX:
            raise ValueError(f"sequence length {tokens.shape[-1]} exceeds "
                             f"T_MAX={T_MAX}")
        cd = compute_dtype or torch.float32
        logits, _, _ = self._run(tokens, cd, _Wiring(tp_group, tp_recipe))
        return logits

    def prefill(self, tokens: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = None,
                tp_group=None, tp_recipe: Optional[Dict[str, str]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The causal forward over a prompt ``[B, T_bucket]`` that also
        returns the blocks' keys and values: ``(logits [B, T, V] float32,
        k, v)`` with ``k``/``v`` stacked ``[L, B, T, h_local, hd]``, the
        image a cache slot stores.  Padding past the true prompt is masked
        at decode time (by the stream's length), never here."""
        cd = compute_dtype or torch.float32
        logits, ks, vs = self._run(tokens, cd, _Wiring(tp_group, tp_recipe))
        return logits, torch.stack(ks, dim=0), torch.stack(vs, dim=0)

    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                    compute_dtype: Optional[torch.dtype] = None,
                    tp_group=None,
                    tp_recipe: Optional[Dict[str, str]] = None
                    ) -> torch.Tensor:
        """One decode step over every cache slot: ``tokens`` ``[S]`` (each
        slot's input token), ``positions`` ``[S]`` (its position, the
        slot's length so far), ``k_cache``/``v_cache`` ``[L, S, T_max,
        h_local, hd]`` in the compute dtype.  Each slot's new key and value
        are written into the caches IN PLACE at its position (one scatter a
        layer; no second cache is made), then each slot attends over its
        positions ``0..position``.  Returns the float32 logits ``[S, V]``.
        Slots nobody reads compute garbage: the shape stays fixed."""
        cd = compute_dtype or torch.float32
        wiring = _Wiring(tp_group, tp_recipe)
        e = self.embed
        t_max = k_cache.shape[2]
        pos = positions.long()
        x = (e.tok.to(cd)[tokens.long()] + e.pos.to(cd)[pos])[:, None, :]
        slots = torch.arange(k_cache.shape[1], device=k_cache.device)
        valid = (torch.arange(t_max, device=k_cache.device)[None, :]
                 <= pos[:, None])                       # [S, T_max]
        mask = valid[:, None, None, :]
        for i, blk in enumerate(self.blocks):
            path = f"blocks/block{i}"
            h = blk.ln1(x)
            q, k, v = split_heads(_proj(h, blk.attn.qkv, f"{path}/attn/qkv",
                                        wiring, cd))    # [S, 1, h, hd]
            kc, vc = k_cache[i], v_cache[i]             # [S, T_max, h, hd]
            kc[slots, pos] = k[:, 0].to(kc.dtype)
            vc[slots, pos] = v[:, 0].to(vc.dtype)
            a = attention(q, kc.to(cd), vc.to(cd), mask)
            a = a.reshape(*a.shape[:-2], -1)
            x = x + _proj(a, blk.attn.out, f"{path}/attn/out", wiring, cd)
            x = x + _mlp(blk.ln2(x), blk, path, wiring, cd)
        return _head(x, self.head, cd)[:, 0, :].float()
