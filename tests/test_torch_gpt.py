"""The PyTorch port's GPT against the JAX package's, plus the port's
hygiene rules.

A small GPT (vocab 256, hidden 128, 2 layers, 2 heads of 64, seq 128) is
built by the JAX package; its param_dict crosses to the port as numpy
arrays (paddle_tpu_torch.interop).  Forward logits and loss must agree:
float32 atol = rtol = 1e-4 (two layers of matmuls summed in another
order), bfloat16 3e-2 on logits of the bf16 model.

Hygiene: the port imports neither jax nor paddle_tpu (an AST scan and a
subprocess import), and its entry points default to CUDA and raise on a
host without it instead of running on the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_jax_param_dict, params_from_numpy
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from torch_threads import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)


def _np_params(model):
    return {n: np.asarray(v) for n, v in jnn.param_dict(model).items()}


@pytest.fixture(scope="module")
def pair():
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**SMALL))
    tm = GPT(GPTConfig(**SMALL), device="cpu")
    load_jax_param_dict(tm, _np_params(jm))
    return jm, tm


def _ids(seed, shape=(2, 128), vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def test_param_names_and_shapes_match(pair):
    jm, tm = pair
    jp = jnn.param_dict(jm)
    tp = tnn.param_dict(tm)
    assert set(jp) == set(tp)
    assert "blocks.1.attn.q_proj.weight" in tp
    for n in jp:
        assert tuple(jp[n].shape) == tuple(tp[n].shape), n
    # Linear weights keep the reference layout [in, out]
    assert tuple(tp["blocks.0.fc1.weight"].shape) == (128, 512)


def test_forward_logits_and_loss_match_fp32(pair):
    jm, tm = pair
    ids = _ids(1)
    labels = np.roll(ids, -1, axis=1)
    want = np.asarray(jm(jnp.asarray(ids)))
    want_loss = float(jm.loss(jnp.asarray(ids), jnp.asarray(labels)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        got_loss = float(tm.loss(torch.from_numpy(ids),
                                 torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-4, rtol=1e-4)


def test_forward_logits_match_bf16():
    np.random.seed(2)
    jm = JGPT(JGPTConfig(dtype="bfloat16", **SMALL))
    tm = GPT(GPTConfig(dtype="bfloat16", **SMALL), device="cpu")
    load_jax_param_dict(tm, _np_params(jm))
    assert tm.wte.weight.dtype == torch.bfloat16
    ids = _ids(3, shape=(1, 128))
    want = np.asarray(jm(jnp.asarray(ids)).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).float().numpy()
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_functional_call_substitutes_params(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids(4, shape=(1, 16)))
    params = {n: p.detach() * 0.5 for n, p in tm.named_parameters()}
    other = GPT(GPTConfig(**SMALL), device="cpu")
    tnn.load_param_dict(other, params)
    with torch.no_grad():
        got = tnn.functional_call(tm, params, ids)
        want = other(ids)
        base = tm(ids)
    torch.testing.assert_close(got, want)
    assert not torch.allclose(got, base)          # tm's own weights untouched


def test_multihead_attention_layer_matches_reference():
    np.random.seed(5)
    jl = jnn.MultiHeadAttention(64, 4)
    tl = tnn.MultiHeadAttention(64, 4, device="cpu")
    tnn.load_param_dict(tl, params_from_numpy(_np_params(jl), device="cpu"))
    x = np.random.default_rng(6).normal(size=(2, 10, 64)).astype(np.float32)
    mask = np.tril(np.ones((10, 10), bool))[None, None]
    want = np.asarray(jl(jnp.asarray(x), attn_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    got = tnn.functional.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


def test_interop_rejects_mismatched_names_and_shapes(pair):
    jm, _ = pair
    params = _np_params(jm)
    tm = GPT(GPTConfig(**SMALL), device="cpu")
    missing = dict(params)
    missing.pop("norm_f.bias")
    with pytest.raises(KeyError, match="norm_f.bias"):
        load_jax_param_dict(tm, missing)
    with pytest.raises(ValueError, match="shape"):
        tnn.load_param_dict(tm, {"norm_f.bias": np.zeros(3, np.float32)})


def test_seeded_init_is_reproducible():
    cfg = GPTConfig(**SMALL)
    a = GPT(cfg, device="cpu", generator=tnn.make_generator(7))
    b = GPT(cfg, device="cpu", generator=tnn.make_generator(7))
    c = GPT(cfg, device="cpu", generator=tnn.make_generator(8))
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.wte.weight, c.wte.weight)
    # norms start at ones / zeros, biases at zeros, as in the reference
    assert torch.equal(a.norm_f.weight, torch.ones(128))
    assert torch.equal(a.blocks[0].fc1.bias, torch.zeros(512))


def test_unported_options_raise():
    """GPT MoE builds (tests/test_torch_gpt_moe.py holds it to the
    reference); item 8 is ported whole: the rule meshes of the sharding
    analyzer are made (in this process here; tests/test_torch_spmd_runtime.py
    runs them), and a device list shorter than the mesh raises the
    reference's ValueError (tensor parallelism and ZeRO-1:
    tests/test_torch_tensor_parallel.py, tests/test_torch_zero_fsdp.py)."""
    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.distributed import mesh as tmesh

    m = GPT(GPTConfig(num_experts=4, **SMALL), device="cpu")
    assert m.blocks[0].moe.w1.shape == (4, 128, 512)
    ranks = inprocess.local_meshes(axes={"dp": 1, "mp": 2}, device="cpu")
    assert [r.shape for r in ranks] == [{"dp": 1, "mp": 2}] * 2
    assert tmesh.MeshLayout(ranks).data_rows == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_rule_mesh({"dp": 1, "mp": 2}, devices=["cpu"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_softmax_ce_matches_reference(dtype):
    """ce_vocab_chunk = 64 (4 chunks of the 256 vocab): the streamed CE's
    loss and its grads w.r.t. h and wte against the reference's
    `streaming_softmax_ce`, and the chunked model loss against the plain
    one.  f32 atol = rtol = 1e-5 (one matmul and an online logsumexp);
    bf16 3e-2 (the port rounds each chunk's logits to bf16 before the f32
    reduction, the reference accumulates straight into f32)."""
    from paddle_tpu.models.gpt import streaming_softmax_ce as j_ce

    from paddle_tpu_torch.models.gpt import streaming_softmax_ce

    rng = np.random.default_rng(7)
    h = rng.normal(size=(2, 16, 128)).astype(np.float32)
    wte = (rng.normal(size=(256, 128)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 256, size=(2, 16), dtype=np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, (dh, dw) = jax.value_and_grad(
        lambda a, b: j_ce(a, b, jnp.asarray(labels), 64), argnums=(0, 1))(
            jnp.asarray(h, jdt), jnp.asarray(wte, jdt))
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(wte).to(tdt).requires_grad_()
    got = streaming_softmax_ce(th, tw, torch.from_numpy(labels), 64)
    gh, gw = torch.autograd.grad(got, (th, tw))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for a, b in ((got, want), (gh, dh), (gw, dw)):
        np.testing.assert_allclose(
            a.detach().float().numpy(),
            np.asarray(jnp.asarray(b).astype(jnp.float32)),
            atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="must divide"):
        streaming_softmax_ce(th, tw, torch.from_numpy(labels), 100)
    # the model's loss: chunked == plain
    np.random.seed(8)
    plain = GPT(GPTConfig(**SMALL), device="cpu")
    chunked = GPT(GPTConfig(ce_vocab_chunk=64, **SMALL), device="cpu")
    tnn.load_param_dict(chunked, dict(plain.named_parameters()))
    ids = torch.from_numpy(_ids(9, shape=(2, 32)))
    with torch.no_grad():
        torch.testing.assert_close(chunked.loss(ids, ids), plain.loss(ids, ids),
                                   atol=1e-5, rtol=1e-5)


def test_sequence_longer_than_max_seq_len_raises(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tm(torch.zeros((1, 129), dtype=torch.int32))


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_and_never_the_cpu():
    cfg = GPTConfig(**SMALL)
    if torch.cuda.is_available():
        assert GPT(cfg).wte.weight.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT(cfg)
    from paddle_tpu_torch.models import generate as G
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.init_cache(G.DecCfg.from_model_cfg(cfg), 1, 8)


def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_paddle_tpu():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_the_port_loads_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.models.generate, paddle_tpu_torch.interop, "
        "paddle_tpu_torch.kernels.fused_probe, "
        "paddle_tpu_torch.tools.fused_probe, "
        "paddle_tpu_torch.tools.near_ties, paddle_tpu_torch.framework, "
        "paddle_tpu_torch.layers, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.executor, paddle_tpu_torch.backward, "
        "paddle_tpu_torch.layer_helper, paddle_tpu_torch.initializer, "
        "paddle_tpu_torch.param_attr, paddle_tpu_torch.unique_name, "
        "paddle_tpu_torch.ops.registry, paddle_tpu_torch.ops.math_ops, "
        "paddle_tpu_torch.ops.tensor_ops, "
        "paddle_tpu_torch.models.static_zoo\n"
        "import paddle_tpu_torch as fluid\n"
        "fluid.models.static_zoo.build('gpt')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
