"""The transformer workload of the port (``ddp_tpu_torch/models/
transformer.py``, ``interop.py``'s rules for it, its TP plan and stage
table, ``train/lm.py``) against ``ddp_tpu`` on seeded numpy inputs, with
the weights carried across by ``interop.py`` and TF32 off.

Tolerances: the encoder's and the LM's float32 logits within atol 2e-5 of
JAX's (XLA and PyTorch sum the products in other orders; measured below
2e-6), every ``forward_blocks`` cut too; prefill's K/V stacks and one
decode step's logits and caches at the same 2e-5; under ``--bf16`` the
logits within 2^-5 of max |logit| (bfloat16's own size: XLA keeps bf16
intermediates in float32 on the CPU where the port rounds); 10
``train_lm`` steps at world 1: losses within 1e-5 relative and parameters
within 1e-4 of JAX's; the synthetic corpus bit for bit; the plan's specs,
table text and collective counts, and the stage tables, equal to JAX's.
The TP step at mesh (1, 2), two gloo ranks on the CPU, against the
world-1 port run: losses within 1e-5 relative, parameters within 1e-5.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddp_tpu.models import transformer as jt
from ddp_tpu.parallel.mesh import make_mesh as jmake_mesh
from ddp_tpu.parallel.pp import partition as jpart
from ddp_tpu.parallel.tp import plan as jplan
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train import lm as jlm
from ddp_tpu_torch import interop
from ddp_tpu_torch.models import ALL_NAMES, NAMES, get_model
from ddp_tpu_torch.models import transformer as tt
from ddp_tpu_torch.parallel.pp import partition as tpart
from ddp_tpu_torch.parallel.tp import plan as tplan
from ddp_tpu_torch.serve import ServeEngine
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import lm as tlm
from ddp_tpu_torch.train.step import make_eval_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
ATOL = 2e-5
BF16_SHARE = 2.0 ** -5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port(name, params):
    m = get_model(name)
    m.load_state_dict(interop.state_dict_from_jax(name, _np(params), {}))
    return m


def _max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x, np.float64) - y).max())
               for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def enc():
    params, _ = jt.init(jax.random.PRNGKey(3))
    return params, _port("transformer", params)


@pytest.fixture(scope="module")
def lm():
    params, _ = jt.lm_init(jax.random.PRNGKey(7))
    return params, _port("tinylm", params)


def _images(n, seed=0):
    return np.random.default_rng(seed).random((n, 32, 32, 3)).astype(
        np.float32)


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


# -- the registry, the rules ------------------------------------------------

def test_registry_and_interop_round_trip(enc, lm):
    assert ALL_NAMES == NAMES + ("transformer", "tinylm")
    assert get_model("transformer").name == "transformer"
    assert get_model("tinylm").name == "tinylm"
    for name, (params, model) in (("transformer", enc), ("tinylm", lm)):
        tree = _np(params)
        assert interop.model_of_tree(tree) == name
        back, stats = interop.jax_from_state_dict(name, model.state_dict())
        assert stats == {} and _max_diff(tree, back) == 0.0
        assert sorted(interop.param_tree_paths(model)) == sorted(
            "/".join(k.key for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(params)[0])
    # The LM's linears are [out, in]: the JAX [in, out] transposed.
    qkv = lm[1].blocks[0].attn.qkv.weight
    np.testing.assert_array_equal(
        qkv.detach().numpy(),
        np.asarray(lm[0]["blocks"]["block0"]["attn"]["qkv"]["weight"]).T)


def test_init_draws_the_jax_distributions():
    """Fresh weights: the linears' U(+-1/sqrt(fan_in)), 0.02 N(0,1) tables,
    LayerNorm ones and zeros; one seed gives one model."""
    a = get_model("tinylm", generator=torch.Generator().manual_seed(5))
    b = get_model("tinylm", generator=torch.Generator().manual_seed(5))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    w = a.blocks[1].mlp.fc2.weight.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(tt.MLP_HIDDEN)
    assert abs(float(a.embed.tok.detach().std()) - 0.02) < 2e-3
    assert torch.equal(a.head.ln.weight, torch.ones(tt.D_MODEL))
    assert torch.equal(a.blocks[0].ln2.bias, torch.zeros(tt.D_MODEL))


# -- forwards ---------------------------------------------------------------

def test_encoder_logits_and_every_cut_match_jax(enc):
    params, model = enc
    x = _images(3)
    want, _ = jt.apply(params, {}, jnp.asarray(x), train=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = model(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    n = len(tt.PP_BLOCKS)
    assert tt.PP_BLOCKS == jt.PP_BLOCKS
    for cut in range(1, n):
        ja, _ = jt.apply_blocks(params, {}, jnp.asarray(x),
                                blocks=(0, cut), train=False)
        jb, _ = jt.apply_blocks(params, {}, ja, blocks=(cut, n),
                                train=False)
        with torch.no_grad():
            ta = model.forward_blocks(xt, (0, cut))
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                       atol=ATOL, rtol=0)
            tb = model.forward_blocks(torch.from_numpy(np.array(ja)),
                                      (cut, n))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL,
                                   rtol=0)
    with pytest.raises(ValueError, match="non-empty range"):
        model.forward_blocks(xt, (2, 2))


def test_lm_forward_prefill_and_decode_match_jax(lm):
    params, model = lm
    toks = _tokens(2, 20)
    want, _ = jt.lm_apply(params, {}, jnp.asarray(toks), train=False)
    with torch.no_grad():
        got = model.lm_forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="T_MAX"):
        model.lm_forward(torch.zeros((1, tt.T_MAX + 1), dtype=torch.long))
    # Prefill: logits and the [L, B, T, h, hd] K/V stacks.
    jl, jk, jv = jt.lm_prefill(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, tk, tv = model.prefill(torch.from_numpy(toks))
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    # One decode step over 3 slots at different positions, from caches
    # holding seeded values: logits and the caches written at positions.
    rng = np.random.default_rng(1)
    shape = (tt.N_LAYERS, 3, tt.T_MAX, tt.N_HEADS, tt.HEAD_DIM)
    kc = rng.normal(0, 1, shape).astype(np.float32)
    vc = rng.normal(0, 1, shape).astype(np.float32)
    tokens = np.array([5, 200, 17], np.int32)
    pos = np.array([0, 9, 127], np.int32)
    jlog, jkc, jvc = jt.lm_decode_step(params, jnp.asarray(tokens),
                                       jnp.asarray(pos), jnp.asarray(kc),
                                       jnp.asarray(vc))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ptr = tkc.data_ptr()
    with torch.no_grad():
        tlog = model.decode_step(torch.from_numpy(tokens),
                                 torch.from_numpy(pos), tkc, tvc)
    assert tkc.data_ptr() == ptr  # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), atol=ATOL,
                               rtol=0)


def test_bf16_logits_within_bf16_of_jax(enc, lm, capsys):
    """``--bf16``: the blocks in bfloat16, float32 softmax and LayerNorm
    statistics and logits, within 2^-5 of max |logit| of JAX's bf16
    forward."""
    x = _images(2, seed=4)
    toks = _tokens(2, 16, seed=4)
    jenc, _ = jt.apply(enc[0], {}, jnp.asarray(x), train=False,
                       compute_dtype=jnp.bfloat16)
    jlmo, _ = jt.lm_apply(lm[0], {}, jnp.asarray(toks), train=False,
                          compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        tenc = enc[1](torch.from_numpy(x).permute(0, 3, 1, 2),
                      compute_dtype=torch.bfloat16)
        tlmo = lm[1].lm_forward(torch.from_numpy(toks),
                                compute_dtype=torch.bfloat16)
    for got, want in ((tenc, jenc), (tlmo, jlmo)):
        assert got.dtype == torch.float32
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        print(f"bf16 max err {err:.3g} of max |logit| "
              f"{np.abs(want).max():.3g}")
        assert err <= BF16_SHARE * float(np.abs(want).max())


def test_encoder_serves_through_gather_batch(enc):
    """``ServeEngine`` serving the encoder: its programs take uint8 NHWC
    through ``gather_batch`` (u8/255, channels-first), and the served
    logits equal JAX's forward of the same images scaled alike."""
    params, model = enc
    eng = ServeEngine(model, device="cpu", buckets=(1, 4))
    assert eng.warm() == 2
    imgs = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3)
                                             ).astype(np.uint8)
    got = eng.forward(imgs)
    want, _ = jt.apply(params, {}, jnp.asarray(imgs.astype(np.float32)
                                               / 255.0), train=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        got, make_eval_apply(model)(torch.from_numpy(imgs)).numpy()[:3])


# -- plans and stage tables ----------------------------------------------------

@pytest.mark.parametrize("name,m", [("transformer", 1), ("transformer", 2),
                                    ("tinylm", 2), ("tinylm", 4)])
def test_tp_plan_equals_jax(enc, lm, name, m):
    params = (enc if name == "transformer" else lm)[0]
    jp = jplan.plan_for_model(name, params, {}, model_size=m)
    tp = tplan.plan_for_model(name, get_model(name, device="meta"),
                              model_size=m)
    jspecs = {"/".join(k.key for k in path): tuple(spec) for path, spec in
              jax.tree_util.tree_flatten_with_path(
                  jp.param_specs, is_leaf=lambda x: isinstance(x, P))[0]}
    assert tp.tree_specs == jspecs
    if m > 1:
        assert tp.param_specs["blocks/block0/attn/qkv/weight"] == \
            ("model", None)
        assert tp.param_specs["blocks/block1/mlp/fc2/weight"] == \
            (None, "model")
    for backward in (True, False):
        assert tplan.expected_collectives(tp, backward=backward) == \
            jplan.expected_collectives(jp, backward=backward)
        assert tplan.format_collective_table(tp, backward=backward) == \
            jplan.format_collective_table(jp, backward=backward)
    assert tplan.expected_collectives(tp, backward=True)[
        "psum_model"] == 4 * tt.N_LAYERS  # fwd 2 and bwd 2 a block
    assert tplan.local_param_count(tp) == jplan.local_param_count(jp)
    jt_, tt_ = (jplan.format_plan_table(jp).splitlines(),
                tplan.format_plan_table(tp).splitlines())
    assert len(jt_) == len(tt_) and tt_[0] == jt_[0]
    assert tt_[-2:] == jt_[-2:]
    for a, b in zip(jt_[2:-2], tt_[2:-2]):
        fa, fb = a.split(), b.split()
        assert (fa[0], fa[1], fa[-1]) == (fb[0], fb[1], fb[-1])


@pytest.mark.parametrize("name", ["transformer", "tinylm"])
def test_stage_tables_equal_jax(enc, name):
    """Both models' stage tables at s = 2, 3, 4 (uniform costs in both
    packages: the JAX cost model's heavy ops do not map one to one onto
    the transformer recipe, and the LM takes tokens)."""
    meta = get_model(name, device="meta")
    assert tpart.layer_forward_costs(name, meta) is None
    for s in (2, 3, 4):
        for m in (1, 2):
            jp = (jpart.plan_stages(name, s, model_size=m, params=enc[0])
                  if name == "transformer"
                  else jpart.plan_stages(name, s, model_size=m))
            tp = tpart.plan_stages(name, s, model_size=m, model=meta)
            assert tpart.format_stage_table(tp, 4) == \
                jpart.format_stage_table(jp, 4)
    with pytest.raises(ValueError) as j:
        jpart.plan_stages(name, 5)
    with pytest.raises(ValueError) as t:
        tpart.plan_stages(name, 5)
    assert str(t.value) == str(j.value)


def test_plan_and_stage_table_modules(enc, capsys):
    from ddp_tpu_torch.parallel.pp.__main__ import main as pp_main
    from ddp_tpu_torch.parallel.tp.__main__ import main as tp_main
    assert tp_main(["--model", "tinylm", "--mesh_shape", "2,4"]) == 0
    out = capsys.readouterr().out
    jp = jplan.plan_for_model("tinylm", jt.lm_init(jax.random.key(0))[0],
                              model_size=4)
    assert out.splitlines()[0] == jplan.format_plan_table(jp).splitlines()[0]
    assert out.splitlines()[-1] == \
        "expected collectives: psum(model) fwd=4 bwd=4 train=8"
    assert pp_main(["--model", "transformer", "--stages", "2",
                    "--microbatches", "4"]) == 0
    out = capsys.readouterr().out.rstrip("\n")
    assert out == jpart.format_stage_table(
        jpart.plan_stages("transformer", 2, params=enc[0]), 4)


# -- training -------------------------------------------------------------------

def test_synthetic_tokens_bit_for_bit():
    for n, t, seed in ((64, 32, 0), (8, 16, 3), (5, 128, 11)):
        a = jlm.synthetic_tokens(n, t, vocab=256, seed=seed)
        b = tlm.synthetic_tokens(n, t, vocab=256, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jlm") / "ck.npz")
    state, losses = jlm.train_lm(steps=10, batch=8, seq_len=16,
                                 mesh=jmake_mesh(1), seed=0,
                                 snapshot_path=path, quiet=True)
    return state, losses, path


def test_train_lm_ten_steps_match_jax(jax_run, tmp_path):
    jstate, jlosses, jpath = jax_run
    start = _port("tinylm", jt.lm_init(jax.random.PRNGKey(0))[0])
    path = str(tmp_path / "ck.npz")
    state, losses = tlm.train_lm(steps=10, batch=8, seq_len=16,
                                 device="cpu", seed=0, quiet=True,
                                 model=start, snapshot_path=path)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    assert losses[-1] < losses[0]
    got, _ = interop.jax_from_state_dict("tinylm", state.model.state_dict())
    assert _max_diff(_np(jstate.params), got) <= 1e-4
    # The port's v1 file is the JAX file: each restores the other's.
    ck = jckpt.load_checkpoint(path)
    assert int(ck.step) == 10 and int(ck.epoch) == 0
    assert _max_diff(_np(ck.params), got) == 0.0
    jck = tckpt.load_checkpoint(jpath)
    model = get_model("tinylm")
    tckpt.restore(jck, model)
    assert _max_diff(_np(jstate.params), interop.jax_from_state_dict(
        "tinylm", model.state_dict())[0]) == 0.0
    with pytest.raises(tckpt.CheckpointError, match="tinylm"):
        tckpt.restore(jck, get_model("transformer"))


def test_tp_step_at_1x2_equals_world1_and_serves_on_1d(tmp_path):
    """``python -m ddp_tpu_torch.train.lm --mesh_shape 1,2``: two gloo
    ranks on the CPU, the plan table printed, the losses and the gathered
    checkpoint equal to the world-1 run's, and the file served by the 1-D
    engine as the world-1 model's forward."""
    from ddp_tpu_torch.serve import KVCacheEngine
    res = str(tmp_path / "r.json")
    ck = str(tmp_path / "tp" / "ck.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.train.lm", "--steps", "4",
         "--batch", "8", "--seq_len", "16", "--device", "cpu",
         "--mesh_shape", "1,2", "--snapshot_path", ck, "--result_json",
         res], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "tensor-parallel plan: tinylm | model axis m=2" in proc.stdout
    out = json.load(open(res))
    assert out["world"] == 2 and out["mesh_shape"] == [1, 2]
    assert out["collectives"]["psum_model_fwd"] > 0
    state, losses = tlm.train_lm(steps=4, batch=8, seq_len=16, device="cpu",
                                 seed=0, quiet=True)
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5, atol=0)
    saved = tckpt.load_checkpoint(ck)
    want, _ = interop.jax_from_state_dict("tinylm",
                                          state.model.state_dict())
    assert _max_diff(want, _np(saved.params)) <= 1e-5
    eng = KVCacheEngine.from_checkpoint(ck, "tinylm", device="cpu", slots=2,
                                        prompt_buckets=(8,))
    prompt = [3, 1, 4, 1, 5]
    slot, tok = eng.start_stream(prompt)
    served = get_model("tinylm")
    tckpt.restore(saved, served)
    with torch.no_grad():
        row = served.lm_forward(torch.tensor([prompt]))[0, -1]
    assert tok == int(np.argmax(row.numpy()))


def test_lm_cli_refusals():
    with pytest.raises(SystemExit, match="D or D,M"):
        tlm.main(["--mesh_shape", "1,2,2", "--device", "cpu"])
    with pytest.raises(ValueError, match="T_MAX"):
        tlm.train_lm(steps=1, batch=2, seq_len=tt.T_MAX + 1, device="cpu")
