"""Port parity for the conv-candidate probe path: ``ddp_tpu_torch.ops``'
``conv_candidates``, ``conv_probe`` and ``pool_candidates`` against
``ddp_tpu.ops``' on the same seeded numpy inputs, NHWC / HWIO, both on the
CPU.  The port's fused candidate takes its kernel's plain version there;
the JAX package's Pallas kernel runs in interpret mode.

Tolerances: the convolutions compare at rtol/atol 1e-4, the JAX package's
own test tolerance (``tests/test_conv_candidates.py``): XLA and PyTorch sum
the K = 9*Cin products, and the gradients' N*H*W products, in different
orders.  Padding, flips and the pool move values, so they compare exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops import conv_candidates as jcc
from ddp_tpu.ops import conv_probe as jprobe
from ddp_tpu.ops import pool_candidates as jpool
from ddp_tpu.ops.layers import conv2d as jconv2d
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.ops import conv_candidates as tcc
from ddp_tpu_torch.ops import conv_probe as tprobe
from ddp_tpu_torch.ops import pool_candidates as tpool

TOL = dict(rtol=1e-4, atol=1e-4)
# (n, h, cin, cout): the JAX test's shape, and an edge shape with a
# 3-channel input, a 4x4 image and 8 output channels.
SHAPES = [(4, 8, 16, 32), (2, 4, 3, 8)]
# Port candidate -> its JAX counterpart, in CANDIDATES order.
PAIRS = [("baseline_cudnn_conv", "baseline_xla_conv"),
         ("shift9_torch", "shift9_lax"),
         ("im2col_torch", "im2col_lax"),
         ("shift9_fused_cuda", "shift9_fused_pallas"),
         ("cuda_fwd_cudnn_bwd", "pallas_fwd_xla_bwd")]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run ``pl.pallas_call`` in interpret mode (the CPU has no TPU)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _inputs(n, h, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, w


def _jax_sin_loss(conv, x, w):
    def loss(x, w):
        return jnp.sum(jnp.sin(conv(x, w)))

    y = conv(jnp.asarray(x), jnp.asarray(w))
    v, (gx, gw) = jax.value_and_grad(loss, (0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    return np.asarray(y), float(v), np.asarray(gx), np.asarray(gw)


def _torch_sin_loss(conv, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv(xt, wt)
    v = y.sin().sum()
    gx, gw = torch.autograd.grad(v, (xt, wt))
    return y.detach().numpy(), float(v.detach()), gx.numpy(), gw.numpy()


def test_candidate_names_and_target_shapes():
    assert [p for p, _ in PAIRS] == list(tcc.CANDIDATES)
    assert [j for _, j in PAIRS] == list(jcc.CANDIDATES)
    assert tcc.TARGET_SHAPES == jcc.TARGET_SHAPES
    assert tcc.CANDIDATES["baseline_cudnn_conv"] is None


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("port,ref", PAIRS, ids=[p for p, _ in PAIRS])
def test_candidate_forward_and_vjp_match_jax(pallas_interpret, shape, port,
                                             ref):
    """The sin-sum loss of the JAX package's candidate test: forward, value
    and both gradients, the Pallas kernel in interpret mode included."""
    x, w = _inputs(*shape)
    tconv = tcc.CANDIDATES[port] or tprobe.conv2d_nhwc
    jconv = jcc.CANDIDATES[ref] or jconv2d
    ty, tv, tgx, tgw = _torch_sin_loss(tconv, x, w)
    jy, jv, jgx, jgw = _jax_sin_loss(jconv, x, w)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(tgx, jgx, **TOL)
    np.testing.assert_allclose(tgw, jgw, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_wrapper_on_cpu_is_the_plain_version(pallas_interpret, shape):
    """On CPU tensors ``conv3x3_fused`` runs ``_shift9_fwd`` (no launch is
    counted) and agrees with the Pallas forward; a float64 input stays
    float64, so the plain version can be the card's float64 reference."""
    x, w = _inputs(*shape, seed=1)
    before = tcc.conv3x3_fused.launches
    got = tcc.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w))
    assert tcc.conv3x3_fused.launches == before
    assert got.dtype == torch.float32 and got.is_contiguous()
    want = jcc._pallas_fwd(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tcc._shift9_fwd(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, plain)
    y64 = tcc.conv3x3_fused(torch.from_numpy(x).double(),
                            torch.from_numpy(w).double())
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_version_accumulates_in_fp32():
    """bfloat16 in, bfloat16 out, sums in fp32: the JAX forward's
    ``preferred_element_type`` contract (one bf16 rounding at the end)."""
    x, w = _inputs(2, 8, 16, 8, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    got = tcc._shift9_fwd(xb, wb)
    assert got.dtype == torch.bfloat16
    want = jcc._shift9_fwd(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                           jnp.asarray(wb.float().numpy(), jnp.bfloat16))
    exact = tcc._shift9_fwd(xb.double(), wb.double())
    # Each is the fp32 sum rounded once to bf16: within one bf16 ulp
    # (2^-7 relative) of the exact sum, and of each other.
    bound = 2.0 ** -7 * exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= bound
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2 * bound)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_im2col_patches_equal_jax(shape):
    x, _ = _inputs(*shape, seed=3)
    got = tcc._im2col_patches(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcc._im2col_patches(x)))


def test_flip_transpose_equals_jax_and_is_a_view():
    _, w = _inputs(1, 4, 5, 7, seed=4)
    got = tcc._flip_transpose(torch.from_numpy(w))
    assert tuple(got.shape) == (3, 3, 7, 5) and not got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcc._flip_transpose(w)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgrad_matches_jax(shape):
    n, h, cin, cout = shape
    x, _ = _inputs(*shape, seed=5)
    dy = np.random.default_rng(6).standard_normal(
        (n, h, h, cout)).astype(np.float32)
    got = tcc._wgrad(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jcc._wgrad(x, dy)), **TOL)


def test_cudnn_bwd_is_the_baseline_convs_own_backward():
    """``_cudnn_bwd`` (the backward without the forward) equals autograd of
    the probe's baseline conv."""
    x, w = _inputs(3, 8, 6, 10, seed=7)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 8, 8, 10)).astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    want = torch.autograd.grad(tprobe.conv2d_nhwc(xt, wt), (xt, wt), dy)
    got = tcc._cudnn_bwd((torch.from_numpy(x), torch.from_numpy(w)), dy)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5)


def test_conv2d_nhwc_returns_contiguous_nhwc():
    x, w = _inputs(2, 8, 4, 6, seed=9)
    y = tprobe.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(y.shape) == (2, 8, 8, 6) and y.is_contiguous()


def test_probe_constants_equal_jax():
    assert tprobe.VGG_CONV_SHAPES == jprobe.VGG_CONV_SHAPES
    assert (tprobe.N_SHORT, tprobe.N_LONG) == (jprobe.N_SHORT, jprobe.N_LONG)
    assert tprobe.NOISE_S_PER_CALL == jprobe.NOISE_S_PER_CALL
    for args in [(512, 32, 64, 128), (8, 4, 512, 512), (3, 5, 7, 9)]:
        assert tprobe.conv_flops(*args) == jprobe.conv_flops(*args)
    assert tpool.VGG_POOL_SHAPES == jpool.VGG_POOL_SHAPES
    assert list(tpool.IMPLS) == ["baseline_max_pool2d",
                                 "reshape_max_first_tie"]
    assert len(tpool.IMPLS) == len(jpool.IMPLS)


def test_probe_records_have_the_jax_keys(monkeypatch, capsys):
    """Both probes at a tiny shape, with short chains for the JAX one (its
    unrolled 50-link programs take long to compile): the same records, key
    for key, and the same JSON lines."""
    monkeypatch.setattr(jprobe, "N_SHORT", 1)
    monkeypatch.setattr(jprobe, "N_LONG", 2)
    want = jprobe.probe(2, 1, shapes=[(4, 8, 8, 1)])
    capsys.readouterr()
    got = tprobe.probe(batch=2, repeats=1, shapes=[(4, 8, 8, 1)],
                       device="cpu")
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()]
    assert printed == got
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["shape"], r["dir"], r["reps_in_vgg"]) for r in got] == \
        [(r["shape"], r["dir"], r["reps_in_vgg"]) for r in want]
    for r in got:
        assert r["marginal_ms_per_call"] > 0
        assert r["tflops"] is None or r["tflops"] >= 0
    assert set(tprobe.summary(got)) == {"sum_marginal_train_ms_per_step",
                                        "noise_limited_train_rows"}


def test_conv_candidates_cli_on_cpu(capsys):
    out = tcc.main(["--batch", "1", "--repeats", "1", "--device", "cpu",
                    "--candidates", "shift9_fused_cuda"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"candidate": "shift9_fused_cuda"}
    assert list(out) == ["shift9_fused_cuda"]
    assert [(r["shape"], r["dir"]) for r in out["shift9_fused_cuda"]] == [
        ("32x32 64->128", "fwd"), ("32x32 64->128", "train(fwd+dgrad+wgrad)"),
        ("8x8 256->512", "fwd"), ("8x8 256->512", "train(fwd+dgrad+wgrad)")]


def test_conv_candidates_typo_is_usage_error(capsys):
    """Counterpart of the JAX CLI's test: a typo in --candidates is an
    argparse error naming the valid candidates, not a KeyError."""
    with pytest.raises(SystemExit) as exc:
        tcc.main(["--candidates", "baseline_cudnn_conv,typo_kernel"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "typo_kernel" in err and "valid:" in err


@pytest.mark.parametrize("entry", [tcc.main, tpool.main])
def test_probe_clis_run_on_the_card_by_default(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError, match="--device cpu"):
        entry(["--repeats", "1"])


def _relu_with_ties(shape, seed):
    """ReLU-like activations with exact zeros and repeated positive values,
    so many 2x2 windows hold tied maxima."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal(shape) - 0.3, 0.0)
    return (np.round(x * 4) / 4).astype(np.float32)


def test_max_pool_reshape_equals_jax_exactly():
    x = _relu_with_ties((3, 8, 6, 5), seed=10)
    dy = np.random.default_rng(11).standard_normal(
        (3, 4, 3, 5)).astype(np.float32)
    jy, vjp = jax.vjp(jpool.max_pool_reshape, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    for pool in (tpool.max_pool_reshape, tpool.max_pool2d_nhwc):
        xt = torch.from_numpy(x).requires_grad_()
        y = pool(xt)
        (dx,) = torch.autograd.grad(y, (xt,), torch.from_numpy(dy))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    # The ties are real: plain autograd of amax would split the cotangent.
    assert (np.asarray(jdx) != 0).sum() == dy.size


def test_pool_probe_records(monkeypatch, capsys):
    monkeypatch.setattr(tpool, "VGG_POOL_SHAPES", [(4, 8)])
    recs = tpool.probe(batch=2, repeats=1, device="cpu")
    assert [r["impl"] for r in recs] == list(tpool.IMPLS)
    for r in recs:
        assert set(r) == {"impl", "shape", "marginal_ms_per_call",
                          "noise_limited"}
        assert r["shape"] == "4x4x8" and r["marginal_ms_per_call"] > 0
    totals = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()[-2:]]
    assert [t["impl"] for t in totals] == list(tpool.IMPLS)
