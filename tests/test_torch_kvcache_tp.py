"""The KV-cache engine at a serving model axis against the JAX package's
(``ddp_tpu/serve/kvcache.py`` under ``plan=``), on the CPU.

- The tensor-parallel half of ``tests/test_kvcache.py::
  test_tp_trained_checkpoint_serves_on_1d_and_tp_meshes``: a ``tinylm``
  checkpoint trained by the JAX package under a (2,4) mesh is served by
  the port's engine at model axis 2 (rank 0 here, one follower process,
  gloo), by the port's 1-D engine, and by JAX's engine under
  ``plan_for_model(model_size=2)`` on a (1,2) mesh.  The three decode the
  same greedy tokens, and every step's logits agree within 1e-5.
- ``ServeFleet(generate=True, model_axis=2)``: one replica of two ranks
  serves token streams equal to the 1-D engine's, and hot-swaps a new
  publish (loaded and warmed on both ranks before its commit); a swap
  whose drain times out retires the old generation on the followers once
  its last stream ends.
- ``ModelGroup``: a follower that hangs in a load fails rank 0's load
  within the group's bound, and frees its lock.
"""
from __future__ import annotations

import datetime
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from ddp_tpu.models import transformer as jtfm
from ddp_tpu.parallel.mesh import make_mesh as jmake_mesh
from ddp_tpu.parallel.tp.plan import plan_for_model as jplan_for_model
from ddp_tpu.serve.kvcache import KVCacheEngine as JEngine
from ddp_tpu.train import lm as jlm
from ddp_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.serve import KVCacheEngine, ServeFleet
from ddp_tpu_torch.serve import model_group
from ddp_tpu_torch.serve.model_group import OP_LOAD, ModelGroup
from ddp_tpu_torch.train import lm as tlm

DECODE_ATOL = 1e-5
PROMPTS = ([1, 2, 3, 4], [5, 250, 17, 3, 99, 8, 200])
STEPS = 6


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The follower processes inherit it: ranks share a small box.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def tp_ck(tmp_path_factory):
    """A tinylm checkpoint trained by the JAX package under tensor
    parallelism on a (2,4) data x model mesh."""
    params, _ = jtfm.lm_init(jax.random.PRNGKey(0))
    plan = jplan_for_model(jtfm.LM_NAME, params, model_size=4)
    path = str(tmp_path_factory.mktemp("tplm") / "ckpt.npz")
    jlm.train_lm(steps=3, batch=8, seq_len=16, mesh=jmake_mesh(shape=(2, 4)),
                 plan=plan, snapshot_path=path, quiet=True)
    return path


def _port_stream(eng, prompt):
    """Greedy tokens and each decode step's logits row of one stream."""
    slot, tok = eng.start_stream(prompt)
    toks, rows = [tok], []
    while len(toks) < STEPS:
        row = eng.decode_logits({slot: toks[-1]})[slot]
        rows.append(row)
        toks.append(int(np.argmax(row)))
    eng.release(slot)
    return toks, np.stack(rows)


def _jax_stream(eng, prompt):
    """The same of JAX's engine; its logits read from its decode
    program's output."""
    rows = []
    decode = eng._decode

    def spy(*args):
        out = decode(*args)
        rows.append(np.asarray(jax.device_get(out[0])))
        return out

    eng._decode = spy
    try:
        slot, tok = eng.start_stream(prompt)
        toks = [tok]
        while len(toks) < STEPS:
            toks.append(eng.decode({slot: toks[-1]})[slot])
        eng.release(slot)
    finally:
        eng._decode = decode
    return toks, np.stack([r[slot] for r in rows])


def test_tp_trained_checkpoint_serves_at_model_axis_2(tp_ck):
    """JAX-trained under (2,4), served three ways: the port at model axis
    2 (two gloo ranks), the port's 1-D engine and JAX's engine under a
    plan of size 2 on a (1,2) mesh: the same tokens, the logits within
    1e-5."""
    jplan = jplan_for_model(jtfm.LM_NAME, jload_checkpoint(tp_ck).params,
                            model_size=2)
    jeng = JEngine.from_checkpoint(tp_ck, jtfm.LM_NAME,
                                   mesh=jmake_mesh(shape=(1, 2)), slots=2,
                                   prompt_buckets=(8,), plan=jplan)
    one = KVCacheEngine.from_checkpoint(tp_ck, "tinylm", device="cpu",
                                        slots=2, prompt_buckets=(8,))
    two = KVCacheEngine.from_checkpoint(tp_ck, "tinylm", device="cpu",
                                        slots=2, prompt_buckets=(8,),
                                        model_axis=2)
    try:
        assert two.warm() == two.compile_bound == 3
        assert two.stats()["mesh_devices"] == 2
        assert two.stats()["model_group"]["backend"] == "gloo"
        assert two.checkpoint_file == tp_ck
        for prompt in PROMPTS:
            t2, l2 = _port_stream(two, prompt)
            t1, l1 = _port_stream(one, prompt)
            tj, lj = _jax_stream(jeng, prompt)
            assert t2 == t1 == tj, prompt
            np.testing.assert_allclose(l2, l1, atol=DECODE_ATOL, rtol=0)
            np.testing.assert_allclose(l2, lj, atol=DECODE_ATOL, rtol=0)
        # Two streams at once on the two ranks: each is its own stream.
        sa, ta = two.start_stream(PROMPTS[0])
        sb, tb = two.start_stream(PROMPTS[1])
        ga, gb = [ta], [tb]
        while len(ga) < STEPS:
            nxt = two.decode({sa: ga[-1], sb: gb[-1]})
            ga.append(nxt[sa])
            gb.append(nxt[sb])
        assert ga == _port_stream(one, PROMPTS[0])[0]
        assert gb == _port_stream(one, PROMPTS[1])[0]
        two.release(sa)
        two.release(sb)
        assert two.free_slots() == 2
    finally:
        two.close()
    assert all(p.poll() is not None for p in two.group._procs)


def test_generative_fleet_at_model_axis_2_serves_and_swaps(tmp_path):
    """One replica of two ranks: streams equal the 1-D engine's on the
    same file; a new publish is loaded and warmed on both ranks, then
    committed, and the streams follow it."""
    path = str(tmp_path / "lm" / "ck.npz")
    tlm.train_lm(steps=4, batch=8, seq_len=16, device="cpu", seed=2,
                 snapshot_path=path, quiet=True)
    fleet = ServeFleet(path, "tinylm", device="cpu", n_replicas=1,
                       generate=True, model_axis=2, slots=2,
                       prompt_buckets=(8,), max_new_tokens=STEPS)
    try:
        def streams():
            return [fleet.generate(p, max_new_tokens=STEPS, timeout=60,
                                   session=f"s{i}")["tokens"]
                    for i, p in enumerate(PROMPTS)]

        def one_d():
            eng = KVCacheEngine.from_checkpoint(path, "tinylm", device="cpu",
                                                slots=2, prompt_buckets=(8,))
            return [_port_stream(eng, p)[0] for p in PROMPTS]

        assert streams() == one_d()
        stats = fleet.stats()["replicas"][0]["engine"]
        assert stats["mesh_devices"] == 2
        assert stats["compiled_executables"] == stats["compile_bound"] == 3
        tlm.train_lm(steps=6, batch=8, seq_len=16, device="cpu", seed=3,
                     snapshot_path=path, quiet=True)
        assert fleet.poll_once() == "swap_commit"
        assert fleet.health()["checkpoint_step"] == 6
        assert fleet._gens["r0"] == 1
        assert streams() == one_d()
    finally:
        fleet.close()
    assert all(p.poll() is not None for p in fleet._groups["r0"]._procs)


def test_fleet_swap_past_its_drain_retires_the_old_generation(tmp_path):
    """A stream outlasts the swap's drain: the commit goes ahead, the old
    generation stays on the follower while its stream runs (and ends with
    the old file's tokens), then is retired there."""
    path = str(tmp_path / "lm" / "ck.npz")
    tlm.train_lm(steps=4, batch=8, seq_len=16, device="cpu", seed=2,
                 snapshot_path=path, quiet=True)
    old_tokens = _port_stream(KVCacheEngine.from_checkpoint(
        path, "tinylm", device="cpu", slots=2, prompt_buckets=(8,)),
        PROMPTS[0])[0]
    fleet = ServeFleet(path, "tinylm", device="cpu", n_replicas=1,
                       generate=True, model_axis=2, slots=2,
                       prompt_buckets=(8,), max_new_tokens=STEPS,
                       drain_timeout_s=0.2)
    group = fleet._groups["r0"]
    try:
        old = fleet.replicas[0].engine
        real, gate, entered = old.decode, threading.Event(), threading.Event()

        def held(tokens):
            entered.set()
            gate.wait(60)
            return real(tokens)

        old.decode = held
        out = {}
        t = threading.Thread(target=lambda: out.update(fleet.generate(
            PROMPTS[0], max_new_tokens=STEPS, timeout=60, session="s")))
        t.start()
        assert entered.wait(30)
        tlm.train_lm(steps=6, batch=8, seq_len=16, device="cpu", seed=3,
                     snapshot_path=path, quiet=True)
        assert fleet.poll_once() == "swap_commit"
        assert fleet.swap_history[-1]["old_drained_clean"] is False
        assert group.gens == {0, 1}
        gate.set()
        t.join(60)
        assert out["tokens"] == old_tokens
        deadline = time.monotonic() + 30
        while group.gens != {1} and time.monotonic() < deadline:
            time.sleep(0.05)
        assert group.gens == {1}
        new = KVCacheEngine.from_checkpoint(path, "tinylm", device="cpu",
                                            slots=2, prompt_buckets=(8,))
        assert fleet.generate(PROMPTS[1], max_new_tokens=STEPS, timeout=60,
                              session="s")["tokens"] == \
            _port_stream(new, PROMPTS[1])[0]
    finally:
        gate.set()
        fleet.close()
    assert all(p.poll() is not None for p in group._procs)


def test_a_follower_hung_in_a_load_fails_it_within_the_bound(monkeypatch):
    """Rank 0's load waits for a follower's vote no longer than the
    group's bound, then raises and frees the group's lock."""
    bound = datetime.timedelta(seconds=2)
    monkeypatch.setattr(model_group, "SUM_TIMEOUT", bound)
    port = dist.free_port()
    store = tdist.TCPStore("127.0.0.1", port, 2, True, timeout=bound * 10,
                           wait_for_workers=False)
    seen, done = {}, threading.Event()

    def follower():
        g = ModelGroup(tdist.TCPStore("127.0.0.1", port, 2, False,
                                      timeout=bound * 10), 1, 2, 8)
        op, _, ints, _ = g.recv()
        seen["op"], seen["path"] = op, g.recv_bytes(int(ints[0])).decode()
        done.wait(30)  # hung in its load until rank 0 has given up
        try:
            g.agree(True)
        except RuntimeError:
            seen["late_vote"] = "failed"

    t = threading.Thread(target=follower, daemon=True)
    t.start()
    lead = ModelGroup(store, 0, 2, 8)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not vote within"):
        lead.load(0, "ck.npz", 1, 0, build=object)
    waited = time.monotonic() - t0
    done.set()
    t.join(30)
    assert seen["op"] == OP_LOAD and seen["path"] == "ck.npz"
    assert seen["late_vote"] == "failed"
    assert bound.total_seconds() <= waited < bound.total_seconds() + 10
    assert lead.lock.acquire(timeout=1)
    lead.lock.release()
    assert lead.gens == set()
