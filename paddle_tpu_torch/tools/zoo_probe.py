"""Two probes of the zoo's training paths on the card, one JSON line per run.

  ghost_bn   The full-subset fused ResNet of tests/test_torch_recompute.py
             (bottleneck depths [1, 1, 1, 1], 10 classes, NHWC, ghost
             batch norm over 2 samples; batch 4, 2 Momentum(1e-3, 0.9)
             steps) at 32x32 and 64x64.  On the CPU: remat=False,
             remat="conv_outs", remat=False with the first batch nudged
             by one ulp, and the unfused per-conv program.  On the card,
             with TF32 on and off (cuDNN and cuBLAS): the fused program
             under remat=False and "conv_outs" and the unfused program.
             Each run's losses and their relative error against the CPU's
             fused remat=False run.  Then, at 32x32 with TF32 off, every
             K7, K8 and K9 launch of one fused step against its plain
             version on the same inputs (max |kernel - plain| over max
             |plain|, and the same in norm, per output); for the K7 and
             K8 backwards also their near-ties (`near_ties.NearTies` on
             the launch's inputs) and `near_ties.hold` per output, the
             rule chip_smoke.py holds f32 K7/K8 launches to.  Last, K8 at
             the stage-4 transition's shape ([4, 2, 2, 1024], Cm 512,
             Cout 2048) on seeded random inputs, the same way.
  bert_loss  BERT-base pretraining at the zoo phase's batch (32 x 512, one
             pretraining batch repeated, AdamW): 6 steps each of the zoo
             phase's run (bf16, dropout 0.1, lr 1e-4) and of variants with
             dropout 0, float32 parameters, a linear lr warm-up over 10
             steps and lr 1e-5.  Per step the training loss and the loss
             of the same batch without dropout at the parameters the step
             started from.

Usage:

    python -m paddle_tpu_torch.tools.zoo_probe [ghost_bn] [bert_loss]

Both parts by default.  Needs one card; the CPU runs of ghost_bn run on
the host beside it.  Exit code 0 when every run finished with finite
losses, 1 otherwise.
"""

import copy
import json
import os
import sys

import numpy as np
import torch

PARTS = ("ghost_bn", "bert_loss")


def _emit(**rec):
    print(json.dumps(rec), flush=True)


def _rel(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


# ---------------------------------------------------------------------------
# ghost_bn
# ---------------------------------------------------------------------------

def _resnet(fused, device):
    from ..models import resnet as R
    from ..nn import make_generator

    m = R.ResNet(R.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                 data_format="NHWC", fused=fused, device=device,
                 generator=make_generator(0))
    return R.set_bn_stats_sample(m, 2)


def _batches(side, n=2):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((4, 3, side, side)).astype(np.float32),
             rng.integers(0, 10, (4,)).astype(np.int32)) for _ in range(n)]


def _steps(fused, remat, device, start, batches):
    from ..models import train as T
    from ..nn import functional as F
    from ..optimizer.functional import Momentum

    model = _resnet(fused, device)
    model.load_state_dict(start)
    opt = Momentum(1e-3, 0.9)
    state = T.init_train_state(model, opt)
    step = T.make_train_step(model, opt, remat=remat,
                             loss_fn=lambda m, x, y: F.cross_entropy(m(x), y))
    losses = []
    for x, y in batches:
        state, loss = step(state, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device))
        losses.append(float(loss))
    return losses


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ghost_bn():
    ok = True
    for side in (32, 64):
        batches = _batches(side)
        start = copy.deepcopy(_resnet(True, "cpu").state_dict())
        nudged = [(np.nextafter(batches[0][0], np.float32(np.inf)),
                   batches[0][1])] + batches[1:]
        want = _steps(True, False, "cpu", start, batches)
        runs = [("cpu", None, "fused remat=False", want),
                ("cpu", None, "fused remat='conv_outs'",
                 _steps(True, "conv_outs", "cpu", start, batches)),
                ("cpu", None, "fused remat=False, first batch +1 ulp",
                 _steps(True, False, "cpu", start, nudged)),
                ("cpu", None, "unfused remat=False",
                 _steps(False, False, "cpu", start, batches))]
        for tf32 in (True, False):
            _set_tf32(tf32)
            for fused, remat in ((True, False), (True, "conv_outs"),
                                 (False, False)):
                runs.append(("cuda", tf32,
                             f"{'fused' if fused else 'unfused'} "
                             f"remat={remat!r}",
                             _steps(fused, remat, "cuda", start, batches)))
        _set_tf32(False)
        for device, tf32, name, losses in runs:
            ok &= bool(np.all(np.isfinite(losses)))
            _emit(part="ghost_bn", side=side, device=device, tf32=tf32,
                  run=name, losses=losses,
                  rel_err_vs_cpu_fused=_rel(losses, want))
    _emit(part="ghost_bn", kernels_vs_plain=_kernels_vs_plain(32))
    _emit(part="ghost_bn", k8_random=_k8_random())
    return ok


def _err(got, ref):
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    return {"max": (got - ref).abs().max().item() / max(scale, 1e-30),
            "norm": ((got - ref).norm() / max(ref.norm().item(), 1e-30)
                     ).item()}


def _kernels_vs_plain(side):
    """One fused remat=False step on the card at `side` with TF32 off,
    every K7/K8/K9 launch held against its plain version on the same
    inputs: {launcher: [{shape, output: {max, norm}}, ...]}."""
    from ..kernels import fused_bottleneck as FB

    pairs = {"_launch_fwd": FB.fused_bottleneck_fwd_ref,
             "_launch_bwd": FB.fused_bottleneck_bwd_ref,
             "_launch_down_fwd": FB.fused_bottleneck_down_fwd_ref,
             "_launch_down_bwd": FB.fused_bottleneck_down_bwd_ref,
             "_launch_stem_fwd": FB.fused_stem_tail_fwd_ref,
             "_launch_stem_bwd": FB.fused_stem_tail_bwd_ref}
    found = {name: [] for name in pairs}
    real = {name: getattr(FB, name) for name in pairs}

    def wrap(name):
        def launch(*args, **kw):
            out = real[name](*args, **kw)
            with torch.no_grad():
                ref = pairs[name](*args)
                rec = {"x": list(args[0].shape)}
                if name in ("_launch_bwd", "_launch_down_bwd"):
                    rec.update(_held(real, *args))
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            rec["errs"] = [_err(o, r) for o, r in zip(outs, refs)
                           if o is not None and r is not None]
            found[name].append(rec)
            return out
        return launch

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = ""
    _set_tf32(False)
    start = copy.deepcopy(_resnet(True, "cpu").state_dict())
    try:
        for name in pairs:
            setattr(FB, name, wrap(name))
        _steps(True, False, "cuda", start, _batches(side, 1))
    finally:
        for name, fn in real.items():
            setattr(FB, name, fn)
    return found


def _held(launchers, x, dy, w1, w2, w3, w4, aff, proj=True):
    """A K7 (`proj` given) or K8 backward launch held as chip_smoke.py
    holds f32 K7/K8 launches: its forward on the card and the plain one
    name the near-ties, then `near_ties.hold` on each output (None where
    it holds)."""
    from ..kernels import fused_bottleneck as FB
    from . import near_ties as NT

    down = dy.shape[1] != x.shape[1]     # K8 halves the sides
    if down:
        y = launchers["_launch_down_fwd"](x, w1, w2, w3, w4, aff)
        y_ref = FB.fused_bottleneck_down_fwd_ref(x, w1, w2, w3, w4, aff)
        got = launchers["_launch_down_bwd"](x, dy, w1, w2, w3, w4, aff)
        want = FB.fused_bottleneck_down_bwd_ref(x, dy, w1, w2, w3, w4, aff)
    else:
        y = launchers["_launch_fwd"](x, w1, w2, w3, w4, aff, proj)
        y_ref = FB.fused_bottleneck_fwd_ref(x, w1, w2, w3, w4, aff, proj)
        got = launchers["_launch_bwd"](x, dy, w1, w2, w3, w4, aff, proj)
        want = FB.fused_bottleneck_bwd_ref(x, dy, w1, w2, w3, w4, aff, proj)
    ties = NT.NearTies(x, w1, w2, w3, w4, aff, proj or down, down, y, y_ref)
    rows = dy.shape[0] * dy.shape[1] * dy.shape[2]
    held = {"y": NT.hold(y, y_ref, ties, "y")}
    for name, g, w in zip(("dx", "dw1", "dw2", "dw3", "dw4", "daff"), got,
                          want):
        if g is not None:
            held[name] = NT.hold(g, w, ties, "dx" if name == "dx" else "sum",
                                 rows)
    # the output relu's masks (y > 0) of the card and of the plain version
    # against float64 products' (pre > 0)
    f32_dot = NT._dot
    NT._dot = lambda a, b: torch.matmul(a.double(), b.double())
    try:
        pre64, m64 = NT.preactivations(*(t.double() for t in (
            x, w1, w2, w3, w4, aff)), proj or down, down)[2]
    finally:
        NT._dot = f32_dot
    flips = {"card": int(((y > 0) != (pre64 > 0)).sum()),
             "plain": int(((y_ref > 0) != (pre64 > 0)).sum()),
             "of": pre64.numel()}
    # and each y's distance from float64's in units of pre's sum of
    # |terms|, over the elements float64 keeps
    on = pre64 > 0
    noise = {k: float(((v.double() - pre64).abs() / m64.clamp_min(1e-30)
                       )[on].max()) if bool(on.any()) else 0.0
             for k, v in (("card", y), ("plain", y_ref))}
    return {"near_ties": str(ties), "hold": held,
            "output_masks_off_float64": flips,
            "y_off_float64_per_sum_of_terms": noise}


def _k8_random(n=4, hw=2, cin=1024, cm=512, cout=2048, seed=0):
    """K8 at one shape on seeded random f32 inputs (He-like weights,
    affines near (1, 0), as chip_smoke.py's `k7_inputs`): each output's
    error against the plain version and `_held`."""
    from ..kernels import fused_bottleneck as FB

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = rnd((n, hw, hw, cin))
    ws = [rnd((cin, cm), cin ** -0.5), rnd((3, 3, cm, cm), (9 * cm) ** -0.5),
          rnd((cm, cout), cm ** -0.5), rnd((cin, cout), cin ** -0.5)]
    affs = [rnd((c,), 0.3) + (1.0 if i % 2 == 0 else 0.0)
            for i, c in enumerate([cm] * 4 + [cout] * 4)]
    aff = FB._pack_affines(affs, cout)
    dy = rnd((n, hw // 2, hw // 2, cout))
    launchers = {k: getattr(FB, k) for k in ("_launch_down_fwd",
                                             "_launch_down_bwd")}
    got = FB._launch_down_bwd(x, dy, *ws, aff)
    want = FB.fused_bottleneck_down_bwd_ref(x, dy, *ws, aff)
    return {"x": [n, hw, hw, cin], "cm": cm, "cout": cout,
            "errs": [_err(g, w) for g, w in zip(got, want)],
            **_held(launchers, x, dy, *ws, aff)}


# ---------------------------------------------------------------------------
# bert_loss
# ---------------------------------------------------------------------------

def _bert_batch(cfg, batch=32, seq=512, seed=0):
    """chip_smoke.py's zoo pretraining batch: 15% of positions labelled
    for the MLM loss, NSP labels, token types, an all-ones mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    mlm = np.where(rng.random((batch, seq)) < 0.15, ids, -100)
    nsp = rng.integers(0, 2, (batch,))
    tt = np.repeat((np.arange(seq) >= seq // 2)[None], batch, 0)
    mask = np.ones((batch, seq))
    return tuple(torch.as_tensor(a, dtype=torch.int32, device="cuda")
                 for a in (ids, mlm, nsp, tt, mask))


def _warmup(step):
    return 1e-4 * torch.clamp((step.float() + 1) / 10, max=1.0)


BERT_VARIANTS = (
    ("bf16, dropout 0.1, lr 1e-4 (the zoo phase)", {"dtype": "bfloat16"},
     1e-4),
    ("bf16, dropout 0, lr 1e-4", {"dtype": "bfloat16",
                                  "hidden_dropout_prob": 0.0,
                                  "attention_probs_dropout_prob": 0.0}, 1e-4),
    ("float32, dropout 0.1, lr 1e-4", {"dtype": "float32"}, 1e-4),
    ("bf16, dropout 0.1, lr 1e-4 warmed up over 10 steps",
     {"dtype": "bfloat16"}, _warmup),
    ("bf16, dropout 0.1, lr 1e-5", {"dtype": "bfloat16"}, 1e-5),
)


def bert_loss(steps=6):
    from ..models import train as T
    from ..models.bert import BertForPretraining, bert_base_config
    from ..nn import make_generator
    from ..optimizer.functional import AdamW

    _set_tf32(False)
    ok = True
    for name, kw, lr in BERT_VARIANTS:
        cfg = bert_base_config(**kw)
        model = BertForPretraining(cfg, device="cuda",
                                   generator=make_generator(0))
        opt = AdamW(lr)
        state = T.init_train_state(model, opt)
        step = T.make_train_step(model, opt)
        evaluate = T.make_eval_step(model, lambda m, *b: m.loss(*b))
        batch = _bert_batch(cfg)
        losses, clean = [], []
        for _ in range(steps):
            clean.append(float(evaluate(state.params, state.buffers,
                                        *batch)))
            state, loss = step(state, *batch)
            losses.append(float(loss))
        ok &= bool(np.all(np.isfinite(losses + clean)))
        _emit(part="bert_loss", run=name, losses=losses,
              losses_without_dropout_before_each_step=clean)
        del model, state, step, evaluate
        torch.cuda.empty_cache()
    return ok


def main(argv=None):
    parts = list(argv if argv is not None else sys.argv[1:]) or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        print(f"zoo_probe: unknown parts {sorted(unknown)}; known {PARTS}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("zoo_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ..kernels import backend

    backend.build()
    ok = True
    for part in parts:
        ok &= {"ghost_bn": ghost_bn, "bert_loss": bert_loss}[part]()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
