"""Generative serving of the port (``ddp_tpu_torch/serve/kvcache.py``,
``serve/token_batcher.py``, ``/generate``, the generative fleet,
``bench --serve --generate`` and ``python -m ddp_tpu_torch.serve_chaos``)
on the CPU, against ``ddp_tpu``'s ``KVCacheEngine`` on the same
checkpoints and against the port's own full-sequence forward.

Tolerances: the engine's cached decode against ``TinyLM.lm_forward`` of
the whole history at every step, across both prompt buckets, within atol
1e-5 (the same float32 math over other shapes; measured below 1e-6) and
the same greedy token; greedy streams token for token against JAX's
engine, a JAX-trained checkpoint served by the port and a port-trained one
served by JAX; two interleaved streams token for token against each alone;
a bfloat16 stream's logits within 2^-5 of max |logit| of JAX's bfloat16
full forward of the same history.  Everything else (slots, the compile
bound, the batcher's limits, HTTP, the fleet, the bench and the drill) is
exact.
"""
import ast
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import transformer as jt
from ddp_tpu.parallel.mesh import make_mesh as jmake_mesh
from ddp_tpu.serve.kvcache import KVCacheEngine as JEngine
from ddp_tpu.train import lm as jlm
from ddp_tpu_torch import bench, interop, serve_chaos
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.serve import (Draining, KVCacheEngine, QueueFull,
                                 RequestTooLarge, ServeEngine, ServeFleet,
                                 SlotsExhausted, TokenBatcher)
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import lm as tlm
from ddp_tpu_torch.train.step import GraphProgram, init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
ENV.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
DECODE_ATOL = 1e-5
BF16_SHARE = 2.0 ** -5
PROMPTS = ([5, 250, 17, 3, 99], [(i * 7 + 1) % 256 for i in range(13)],
           [42])


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_ck(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jlm") / "ck.npz")
    jlm.train_lm(steps=10, batch=8, seq_len=16, mesh=jmake_mesh(1), seed=1,
                 snapshot_path=path, quiet=True)
    return path


@pytest.fixture(scope="module")
def port_ck(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tlm") / "ck.npz")
    tlm.train_lm(steps=10, batch=8, seq_len=16, device="cpu", seed=2,
                 snapshot_path=path, quiet=True)
    return path


def _model(path):
    model = get_model("tinylm")
    tckpt.restore(tckpt.load_checkpoint(path), model)
    return model


def _stream(eng, prompt, n):
    slot, tok = eng.start_stream(prompt)
    got = [tok]
    while len(got) < n:
        got.append(eng.decode({slot: got[-1]})[slot])
    eng.release(slot)
    return got


# -- the engine ---------------------------------------------------------------

def test_cached_decode_equals_lm_forward_every_step(port_ck):
    """Prompts in both buckets (and one of one token): the prefill's token,
    then each decode step's logits against the full-sequence forward of
    the history."""
    model = _model(port_ck)
    eng = KVCacheEngine(model, device="cpu", slots=2, prompt_buckets=(8, 16))
    for prompt in PROMPTS:
        slot, tok = eng.start_stream(prompt)
        hist = list(prompt)
        with torch.no_grad():
            first = model.lm_forward(torch.tensor([hist]))[0, -1].numpy()
        assert tok == int(np.argmax(first))
        for step in range(8):
            hist.append(tok)
            got = eng.decode_logits({slot: tok})[slot]
            with torch.no_grad():
                want = model.lm_forward(torch.tensor([hist]))[0, -1].numpy()
            np.testing.assert_allclose(got, want, atol=DECODE_ATOL, rtol=0,
                                       err_msg=f"step {step}")
            tok = int(np.argmax(got))
            assert tok == int(np.argmax(want))
        eng.release(slot)


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_greedy_streams_equal_jax_engine(jax_ck, port_ck, trained_by):
    """One checkpoint, both engines: token-identical greedy streams."""
    path = jax_ck if trained_by == "jax" else port_ck
    jeng = JEngine.from_checkpoint(path, "tinylm", mesh=jmake_mesh(1),
                                   slots=2, prompt_buckets=(8, 16))
    teng = KVCacheEngine.from_checkpoint(path, "tinylm", device="cpu",
                                         slots=2, prompt_buckets=(8, 16))
    assert teng.checkpoint_file == path and teng.checkpoint_step == 10
    for prompt in PROMPTS:
        assert _stream(teng, prompt, 8) == _stream(jeng, prompt, 8), prompt


def test_concurrent_streams_do_not_cross_talk(port_ck):
    eng = KVCacheEngine(_model(port_ck), device="cpu", slots=3,
                        prompt_buckets=(8, 16))
    a, b = PROMPTS[0], PROMPTS[1]
    alone = [_stream(eng, a, 7), _stream(eng, b, 7)]
    sa, ta = eng.start_stream(a)
    sb, tb = eng.start_stream(b)
    got = [[ta], [tb]]
    for _ in range(6):
        nxt = eng.decode({sa: got[0][-1], sb: got[1][-1]})
        got[0].append(nxt[sa])
        got[1].append(nxt[sb])
    assert got == alone


def test_slots_compile_bound_and_stats(port_ck):
    eng = KVCacheEngine(_model(port_ck), device="cpu", slots=2,
                        prompt_buckets=(16, 8, 16))
    assert eng.prompt_buckets == (8, 16) and eng.compile_bound == 5
    assert eng.warm() == 5 and eng.warm() == 5
    k, v = eng.cache_buffers()
    ptrs = (k.data_ptr(), v.data_ptr())
    s0, _ = eng.start_stream([1, 2, 3])
    s1, _ = eng.start_stream(list(range(12)))
    assert eng.position(s1) == 12
    with pytest.raises(SlotsExhausted):
        eng.start_stream([4])
    eng.decode({s0: 7, s1: 8})
    assert eng.position(s0) == 4
    eng.release(s0)
    assert eng.free_slots() == 1 and eng.active_slots() == 1
    s2, _ = eng.start_stream([9, 9])
    assert s2 == s0
    assert (k.data_ptr(), v.data_ptr()) == ptrs  # written in place
    with pytest.raises(RequestTooLarge, match="prompt bucket 16"):
        eng.start_stream(list(range(17)))
    with pytest.raises(ValueError, match="non-empty"):
        eng.start_stream([])
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        eng.start_stream([256])
    st = eng.stats()
    assert st["compiled_executables"] == st["compile_bound"] == 5
    assert (st["prefills"], st["decode_steps"], st["slots"],
            st["active_slots"]) == (3, 1, 2, 2)
    assert st["tokens_out"] == 5 and st["compute_dtype"] == "float32"
    text = eng.registry.exposition()
    for fam in ("ddp_kvcache_prefills_total", "ddp_kvcache_decode_steps_total",
                "ddp_kvcache_active_slots", "ddp_kvcache_slots",
                "ddp_engine_compiled_executables"):
        assert fam in text
    with pytest.raises(ValueError, match="tinylm"):
        KVCacheEngine.from_checkpoint(port_ck, "transformer", device="cpu")


def test_failed_warm_leaves_the_engine_cold(port_ck, monkeypatch):
    """A program that fails while warm() makes it leaves the engine cold:
    no program taken or counted, no slot taken, and each call that needs
    the programs raises again; once the fault is gone the next call makes
    them all, and the count is the compile bound, not more."""
    model = _model(port_ck)
    eng = KVCacheEngine(model, device="cpu", slots=2, prompt_buckets=(8,))
    decode_step = model.decode_step

    def broken(*args, **kwargs):
        raise RuntimeError("decode fault")

    monkeypatch.setattr(model, "decode_step", broken)
    for call in (eng.warm, lambda: eng.start_stream([1, 2, 3]),
                 lambda: eng.decode_logits({})):
        with pytest.raises(RuntimeError, match="decode fault"):
            call()
        assert not eng.warmed and eng.trace_count == 0
        assert eng.free_slots() == 2
    monkeypatch.setattr(model, "decode_step", decode_step)
    slot, tok = eng.start_stream([1, 2, 3])
    assert eng.warmed and eng.trace_count == eng.compile_bound == 3
    assert _stream(eng, [1, 2, 3], 4)[0] == tok


def test_graph_program_never_runs_eagerly_off_the_cpu():
    """A program on a card device that was not captured raises instead of
    running its function; on the CPU it runs it and keeps its output."""
    calls = []
    prog = GraphProgram(lambda: calls.append(1) or len(calls),
                        torch.device("cuda"), "the probe")
    with pytest.raises(RuntimeError, match="the probe was not captured"):
        prog.run()
    assert calls == [] and prog.output is None
    prog = GraphProgram(lambda: calls.append(1) or len(calls),
                        torch.device("cpu"), "the probe")
    assert prog.run() == 1 and prog.run() == 2 and prog.output == 2


def test_bf16_stream_within_bf16_of_jax(port_ck):
    model = _model(port_ck)
    params = tckpt.load_checkpoint(port_ck).params
    eng = KVCacheEngine(model, device="cpu", slots=1, prompt_buckets=(8,),
                        compute_dtype=torch.bfloat16)
    assert eng.cache_buffers()[0].dtype == torch.bfloat16
    hist = list(PROMPTS[0])
    slot, tok = eng.start_stream(hist)
    rows = []
    for _ in range(5):
        hist.append(tok)
        rows.append(eng.decode_logits({slot: tok})[slot])
        tok = int(np.argmax(rows[-1]))
    # One causal forward of the whole history: row p is position p's.
    want, _ = jt.lm_apply(params, {}, jnp.asarray([hist], jnp.int32),
                          train=False, compute_dtype=jnp.bfloat16)
    want = np.asarray(want)[0, len(PROMPTS[0]):]
    for got, w in zip(rows, want):
        assert np.abs(got - w).max() <= BF16_SHARE * np.abs(w).max()
    assert eng.stats()["compute_dtype"] == "bfloat16"


# -- the batcher ----------------------------------------------------------------

def test_token_batcher_streams_and_limits(port_ck):
    eng = KVCacheEngine(_model(port_ck), device="cpu", slots=2,
                        prompt_buckets=(8, 16))
    eng.warm()
    want = {i: _stream(eng, [i + 1, 2, 3], 5) for i in range(4)}
    b = TokenBatcher(eng, max_new_tokens=5, queue_depth=8).start()
    got = {}

    def go(i):
        got[i] = b.generate([i + 1, 2, 3], timeout=30)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert {i: r["tokens"] for i, r in got.items()} == want
    assert all(r["prompt_len"] == 3 and r["ttft_ms"] > 0
               for r in got.values())
    assert b.generate([1, 2, 3], max_new_tokens=2, timeout=30)["tokens"] \
        == want[0][:2]
    with pytest.raises(RequestTooLarge, match="largest prompt bucket"):
        b.generate(list(range(17)), timeout=5)
    with pytest.raises(RequestTooLarge, match="T_MAX"):
        TokenBatcher(eng, max_new_tokens=120).generate(list(range(16)),
                                                       timeout=5)
    st = b.stats()
    assert (st["completed_streams"], st["rejected_oversize"],
            st["live_streams"]) == (5, 1, 0)
    assert st["tokens_generated"] == 22 and st["ttft_ms"]["p50"] > 0
    assert "ddp_gen_tokens_total" in b.registry.exposition()
    assert b.drain(timeout=10)
    with pytest.raises(Draining):
        b.generate([1], timeout=5)


def test_token_batcher_queue_full_and_abandonment(port_ck):
    """A full queue sheds at once; a caller that times out abandons its
    stream, whose slot the loop reclaims without finishing it."""
    eng = KVCacheEngine(_model(port_ck), device="cpu", slots=1,
                        prompt_buckets=(8,))
    eng.warm()
    b = TokenBatcher(eng, max_new_tokens=30, queue_depth=1)
    errs = []
    t = threading.Thread(target=lambda: errs.append(pytest.raises(
        TimeoutError, b.generate, [1, 2], timeout=0.5)))
    t.start()
    time.sleep(0.2)  # the loop is not started: the request waits queued
    with pytest.raises(QueueFull):
        b.generate([3], timeout=5)
    t.join()
    slow = eng.decode

    def slow_decode(tokens):
        time.sleep(0.05)
        return slow(tokens)

    eng.decode = slow_decode
    b.start()
    with pytest.raises(TimeoutError):
        b.generate([4, 5], timeout=0.3)
    deadline = time.monotonic() + 10
    while eng.active_slots() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.active_slots() == 0
    st = b.stats()
    assert (st["timed_out"], st["shed_queue_full"],
            st["completed_streams"]) == (2, 1, 0)
    assert st["tokens_generated"] < 30
    b.drain(timeout=10)


# -- the serving front ----------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def _serve(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--port", "0", "--model", "tinylm", "--generate", "--trace_spill",
         "", *args], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert " on http://" in line and "/generate" in line, line
    return proc, line.split(" on ")[1].split(" ")[0].rstrip("/")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "drained=clean" in err


def test_generate_over_http_alone_and_as_a_fleet(port_ck):
    eng = KVCacheEngine.from_checkpoint(port_ck, "tinylm", device="cpu",
                                        slots=2, prompt_buckets=(8, 16))
    proc, base = _serve(["--snapshot_path", port_ck, "--slots", "2",
                         "--prefill_buckets", "8,16", "--max_new_tokens",
                         "6"])
    try:
        out = _post(base + "/generate", {"prompt": PROMPTS[0]})
        assert out["tokens"] == _stream(eng, PROMPTS[0], 6)
        assert out["prompt_len"] == 5
        out = _post(base + "/generate", {"prompt": PROMPTS[1],
                                         "max_new_tokens": 3,
                                         "session": "s"})
        assert out["tokens"] == _stream(eng, PROMPTS[1], 3)
        health = _get(base + "/healthz")
        assert health["compiled_executables"] == 5
        assert health["buckets"] == [8, 16]
        stats = _get(base + "/stats")
        assert stats["engine"]["prefills"] == 2
        assert stats["batcher"]["completed_streams"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/generate", {"prompt": list(range(20))})
        assert e.value.code == 413
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/generate", {"tokens": [1]})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict", {"instances": [[[[0] * 3] * 32] * 32]})
        assert e.value.code == 500
    finally:
        _stop(proc)
    proc, base = _serve(["--snapshot_path", port_ck, "--fleet", "2",
                         "--slots", "2", "--prefill_buckets", "8,16",
                         "--max_new_tokens", "4"])
    try:
        hist = {"a": list(PROMPTS[0]), "b": list(PROMPTS[2])}
        for _turn in range(2):
            for sid, h in hist.items():
                out = _post(base + "/generate", {"prompt": h,
                                                 "session": sid})
                assert out["tokens"] == _stream(eng, h, 4)
                h.extend(out["tokens"])
        stats = _get(base + "/stats")
        router = stats["router"]
        assert set(router["sessions"]) == {"a", "b"}
        assert router["session_migrations"] == 0
        served = [r["batcher"]["completed_streams"]
                  for r in stats["replicas"]]
        assert sum(served) == 4
        assert all(r["engine"]["compiled_executables"] == 5
                   for r in stats["replicas"])
        assert _get(base + "/healthz")["healthy_replicas"] == 2
    finally:
        _stop(proc)


def test_classifier_fleet_serves_at_model_axis_2(tmp_path):
    """The repair: the classifier branch serves replicated whatever the
    model axis (the JAX fleet consults no plan there)."""
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    tckpt.save_checkpoint(ck, model, init_train_state(model).momentum, 0, 0)
    fleet = ServeFleet(ck, "deepnn", device="cpu", n_replicas=1,
                       buckets=(8,), model_axis=2)
    try:
        imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3)
                                                 ).astype(np.uint8)
        eng = ServeEngine(model, device="cpu", buckets=(8,))
        eng.warm()
        np.testing.assert_array_equal(fleet.submit(imgs, timeout=30),
                                      eng.forward(imgs))
        with pytest.raises(TypeError, match="generate=True"):
            fleet.generate([1, 2], timeout=30)
    finally:
        fleet.close()


def test_bench_generate_on_cpu(tmp_path, capsys):
    out = bench.main(["--serve", "--generate", "--device", "cpu",
                      "--gen_streams", "2,1", "--serve_secs", "0.5",
                      "--gen_new_tokens", "4", "--gen_slots", "2",
                      "--gen_prefill_buckets", "8,16"])
    rec = out["records"][0]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    gen = rec["generate"]
    assert [p["streams"] for p in gen["curve"]] == [1, 2]
    assert gen["compiled_executables"] == gen["compile_bound"] == 5
    assert rec["value"] == gen["curve"][-1]["tokens_per_sec"] > 0
    for p in gen["curve"]:
        assert p["tokens"] == 4 * p["completed_streams"] > 0
        assert p["ttft_ms"]["p50"] > 0 and p["stream_latency_ms"]["p99"] > 0
    assert rec["device"] == {"name": "cpu", "count": 1}
    assert rec["power_limit_w"] is None
    assert "tinylm generative decode tokens/sec" in rec["metric"]
    with pytest.raises(SystemExit, match="--serve"):
        bench.main(["--generate", "--device", "cpu"])


def test_serve_chaos_drill_passes_on_cpu(tmp_path, port_ck, capsys):
    out = str(tmp_path / "chaos.json")
    assert serve_chaos.main(["--device", "cpu", "--out", out,
                             "--snapshot", port_ck]) == 0
    card = json.load(open(out))
    rec = card["drills"]["generate_replica_crash"]
    assert card["verdict"] == "PASS" and rec["pass"]
    assert rec["failed_turns"] == [] and rec["migrations"] >= 1
    assert rec["ejections"] >= 1 and rec["reference_mismatches"] == []
    assert rec["sessions_pinned_to_victim"] >= 1
    assert "PASS" in capsys.readouterr().out


def _cli_flags(path, help=True):
    """Each ``add_argument`` call of the module at ``path`` with a literal
    flag: its flag and its keywords (``help`` among them or not), as
    source."""
    tree = ast.parse(open(path).read())
    return {call.args[0].value: tuple(sorted(
        (k.arg, ast.unparse(k.value)) for k in call.keywords
        if help or k.arg != "help"))
        for call in ast.walk(tree)
        if isinstance(call, ast.Call)
        and getattr(call.func, "attr", None) == "add_argument"
        and isinstance(call.args[0], ast.Constant)}


def _jax_generate_record() -> set:
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_bench_generate")
    rec = next(n.args[0] for n in ast.walk(fn)
               if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
               == "dumps" and n.args and isinstance(n.args[0], ast.Dict))
    gen = next(v for k, v in zip(rec.keys, rec.values)
               if k.value == "generate")
    return {k.value for k in rec.keys}, {k.value for k in gen.keys}


@pytest.mark.parametrize("jax_path,port,extra", [
    ("ddp_tpu/train/lm.py", "ddp_tpu_torch/train/lm.py",
     {"--device", "--result_json", "--backend"}),
    ("tools/serve_chaos.py", "ddp_tpu_torch/serve_chaos.py", {"--device"}),
    ("bench.py", "ddp_tpu_torch/bench.py", None),
    ("ddp_tpu/serve/__main__.py", "ddp_tpu_torch/serve/__main__.py", None)])
def test_clis_keep_the_jax_flags(jax_path, port, extra):
    """The LM trainer's, the drill's, the bench's generative and the
    server's generative flags: JAX's flags, defaults and help (the port's
    own additions apart; the server's help says what the port's programs
    are, so there the flags and defaults alone)."""
    serve = "serve/" in jax_path
    want = _cli_flags(os.path.join(ROOT, jax_path), help=not serve)
    got = _cli_flags(os.path.join(ROOT, port), help=not serve)
    if extra is None:  # only the generative flags
        names = {f for f in want if f.startswith("--gen")} | {
            "--slots", "--prefill_buckets", "--max_new_tokens"} & set(want)
        want = {f: want[f] for f in names}
        got = {f: got[f] for f in names}
    else:
        assert set(got) - set(want) == extra
        got = {f: got[f] for f in want}
    assert want and got == want


def test_bench_generate_record_keeps_jax_fields(tmp_path):
    keys, gen = _jax_generate_record()
    out = bench.main(["--serve", "--generate", "--device", "cpu",
                      "--gen_streams", "1", "--serve_secs", "0.3",
                      "--gen_new_tokens", "2", "--gen_slots", "1",
                      "--gen_prefill_buckets", "8"])
    rec = out["records"][0]
    assert set(rec) == keys | {"device", "power_limit_w"}
    assert set(rec["generate"]) == gen
