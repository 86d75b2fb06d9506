"""The port's checkpoint module against the JAX package's (its npz
writer), and resume-equals-uninterrupted on the CPU.

- A JAX package TrainState saved with `writer="npz"` loads into a port
  template equal to `interop.train_state_from_jax` of the same state
  (bitwise: the same f32 / int32 values), but the generator: a JAX PRNG
  key has no torch counterpart, so the template's generator is kept.
  `interop.train_state_from_jax_npz` reads the same file.
- A directory the port writes is a checkpoint to the reference
  (`latest_step`, `_verify_manifest`, its `load_checkpoint` of the
  params into a numpy template) and has the reference's array keys.
- The crash window (manifest and marker never written) and a truncated
  or bit-flipped payload fall back to the previous step;
  `CheckpointManager` keeps the last `max_to_keep` and removes crashed
  attempts older than the newest complete step, but not a newer one.
- Resume: 3 steps of a depth-2 GPT with dropout on, a save, 3 more;
  then the checkpoint loaded into a fresh state and the same 3 steps:
  losses, params, moments and the generator's state bitwise equal.  The
  same for the static GPT through `io.save_persistables` /
  `load_persistables` with Adam.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jckpt
from paddle_tpu import nn as jnn
from paddle_tpu.models import train as jtrain
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.optimizer import functional as jopt

import paddle_tpu_torch as fluid
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch import interop
from paddle_tpu_torch.models import static_zoo as tzoo
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn.parameter import make_generator
from paddle_tpu_torch.optimizer import functional as topt

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=64)
LR = 1e-3


def _batch(seed, shape=(2, 64), vocab=256):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, shape).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _jax_state():
    np.random.seed(3)
    jnn.seed(3)
    jm = JGPT(JGPTConfig(**SMALL))
    jo = jopt.AdamW(LR)
    state = jtrain.init_train_state(jm, jo)
    step = jtrain.make_train_step(jm, jo, jit=True)
    x, y = _batch(100)
    state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    return state


def _port_model(seed=0, dropout=0.0):
    return GPT(GPTConfig(dropout=dropout, **SMALL), device="cpu",
               generator=make_generator(seed))


def _equal_states(a, b, skip_rng=False):
    fa, fb = tckpt.flatten_with_path(a), tckpt.flatten_with_path(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Generator):
            if not skip_rng:
                assert torch.equal(x.get_state(), y.get_state()), k
            continue
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def test_reference_npz_checkpoint_loads_into_the_port(tmp_path):
    jstate = _jax_state()
    jckpt.save_checkpoint(str(tmp_path), jstate, 7, writer="npz")
    np_state = jax.tree.map(np.asarray, jstate)
    want = interop.train_state_from_jax(np_state, _port_model(), topt.AdamW(
        LR), device="cpu")
    tmpl = ttrain.init_train_state(_port_model(1), topt.AdamW(LR))
    got, step = tckpt.load_checkpoint(str(tmp_path), tmpl)
    assert step == 7 and tckpt.latest_step(str(tmp_path)) == 7
    _equal_states(got, want, skip_rng=True)
    assert got.rng is tmpl.rng                 # the JAX key does not cross
    path = os.path.join(str(tmp_path), "step_7", "state", "arrays.npz")
    got2 = interop.train_state_from_jax_npz(path, _port_model(2),
                                            topt.AdamW(LR), device="cpu")
    _equal_states(got2, want, skip_rng=True)


def test_port_checkpoint_is_a_reference_checkpoint(tmp_path):
    jstate = jax.tree.map(np.asarray, _jax_state())
    tstate = interop.train_state_from_jax(jstate, _port_model(),
                                          topt.AdamW(LR), device="cpu")
    d = str(tmp_path)
    tckpt.save_checkpoint(d, tstate, 3, extras={"cursor": np.int64(12)})
    assert jckpt.latest_step(d) == 3
    assert jckpt._verify_manifest(os.path.join(d, "step_3"))
    with np.load(os.path.join(d, "step_3", "state", "arrays.npz")) as data:
        keys = set(data.files)
    want = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert keys == want
    # the reference restores its TrainState from the port's file (its
    # `.rng` leaf then holds the generator's bytes, not a PRNG key)
    restored, step = jckpt.load_checkpoint(d, jstate)
    assert step == 3
    assert int(jckpt.load_extras(d)["cursor"]) == 12
    for n, p in tstate.params.items():
        np.testing.assert_array_equal(restored.params[n],
                                      p.detach().numpy())
    for n, slots in jstate.opt_state.items():
        if n != "__step__":
            for k in slots:
                np.testing.assert_array_equal(restored.opt_state[n][k],
                                              jstate.opt_state[n][k])
    assert jckpt.load_topology(d)["step"] == 3


def _st(v):
    return {"w": torch.full((4,), float(v))}


def test_crash_window_falls_back_to_the_previous_step(tmp_path,
                                                      monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(_st(1), 1)

    def crash(path):
        raise RuntimeError("killed before the marker")

    monkeypatch.setattr(tckpt, "_write_manifest", crash)
    with pytest.raises(RuntimeError, match="killed"):
        mgr.save(_st(2), 2)
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(str(tmp_path), "step_2"))
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert jckpt.latest_step(str(tmp_path)) == 1
    state, step = mgr.restore_latest(_st(0))
    assert step == 1 and torch.equal(state["w"], _st(1)["w"])
    mgr.save(_st(2), 2)
    assert tckpt.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_payload_falls_back(damage, tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, _st(1), 1)
    tckpt.save_checkpoint(d, _st(2), 2)
    victim = os.path.join(d, "step_2", "state", "arrays.npz")
    with open(victim, "r+b") as f:
        if damage == "truncate":
            f.truncate(os.path.getsize(victim) - 1)
        else:
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 0xFF]))
    assert tckpt.latest_step(d) == 1
    assert jckpt.latest_step(d) == 1
    state, step = tckpt.load_checkpoint(d, _st(0))
    assert step == 1 and torch.equal(state["w"], _st(1)["w"])


def test_manager_keeps_last_n_and_collects_orphans(tmp_path):
    d = str(tmp_path)
    mgr = tckpt.CheckpointManager(d, max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_st(s), s)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    # a crashed attempt older than the newest complete step goes; one
    # newer (a save in flight) stays
    os.makedirs(os.path.join(d, "step_2", "state"))
    os.makedirs(os.path.join(d, "step_9", "state"))
    assert mgr.save(_st(5), 5) is not None
    assert not os.path.isdir(os.path.join(d, "step_2"))
    assert os.path.isdir(os.path.join(d, "step_9"))
    assert mgr.latest_step() == 5
    assert mgr.save(_st(6), 6, force=False) is not None
    gated = tckpt.CheckpointManager(d, save_interval_steps=4)
    assert gated.save(_st(7), 7) is None


def test_orbax_and_resharding_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.save_checkpoint(str(tmp_path), _st(1), 1, writer="orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.CheckpointManager(str(tmp_path), writer="orbax")
    os.makedirs(os.path.join(str(tmp_path), "step_4", "state"))
    with open(os.path.join(str(tmp_path), "step_4", "_COMPLETE"), "w") as f:
        f.write("ok\n")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_checkpoint(str(tmp_path), _st(0), step=4)
    with pytest.raises(NotImplementedError, match="item 8"):
        tckpt.restore_resharded(str(tmp_path), _st(0))
    assert tckpt.resharded_cursor(10, 4, 2, False) == \
        jckpt.resharded_cursor(10, 4, 2, False)


def test_keys_are_the_references_keystr():
    state = {"a": [torch.zeros(1), (torch.ones(2), None)],
             "b": {"c": np.float32(2.0)}, 3: torch.zeros(())}
    got = [k for k, _ in tckpt.flatten_with_path(
        {k: v for k, v in state.items() if k != 3})]
    jtree = {"a": [np.zeros(1), (np.ones(2), None)],
             "b": {"c": np.float32(2.0)}}
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert got == want


def test_dygraph_resume_is_bitwise(tmp_path):
    """3 steps, save, 3 steps; a fresh state loaded from the save takes
    the same 3 steps to the same bits (dropout on: the generator's state
    rides in the checkpoint)."""
    def fresh():
        m = _port_model(dropout=0.1)
        return m, ttrain.init_train_state(m, topt.AdamW(LR), rng_seed=5)

    m, state = fresh()
    step = ttrain.make_train_step(m, topt.AdamW(LR))
    batches = [tuple(torch.from_numpy(a) for a in _batch(i))
               for i in range(6)]
    for b in batches[:3]:
        state, _ = step(state, *b)
    tckpt.save_checkpoint(str(tmp_path), state, 3)
    losses = []
    for b in batches[3:]:
        state, loss = step(state, *b)
        losses.append(loss)
    m2, tmpl = fresh()
    resumed, at = tckpt.load_checkpoint(str(tmp_path), tmpl)
    assert at == 3
    step2 = ttrain.make_train_step(m2, topt.AdamW(LR))
    losses2 = []
    for b in batches[3:]:
        resumed, loss = step2(resumed, *b)
        losses2.append(loss)
    assert all(torch.equal(a, b) for a, b in zip(losses, losses2))
    _equal_states(resumed, state)


def test_static_resume_is_bitwise(tmp_path):
    m = tzoo.build_gpt()
    exe = fluid.Executor("cpu")
    feeds = [m.smoke_feed(4, seed=i) for i in range(6)]

    def run(scope, fs):
        return [exe.run(m.main, feed=f, fetch_list=m.fetches,
                        scope=scope)[0] for f in fs]

    a = fluid.Scope()
    exe.run(m.startup, scope=a)
    run(a, feeds[:3])
    with fluid.scope_guard(a):
        fluid.io.save_persistables(exe, str(tmp_path), m.main)
    want = run(a, feeds[3:])
    b = fluid.Scope()
    with fluid.scope_guard(b):
        fluid.io.load_persistables(exe, str(tmp_path), m.main)
    got = run(b, feeds[3:])
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert set(a.vars) == set(b.vars)
    for n in a.vars:
        assert torch.equal(a.vars[n], b.vars[n]), n
