"""Inference-mode value folds — conv/fc + batch_norm folding and scale
chain collapse (port of paddle_tpu/passes/fold.py).

The reference runs these as framework/ir passes before deployment
(conv_bn_fuse_pass.cc, the *_fuse_pass family); here the fold operates
on a recorded Program plus the concrete parameter VALUES (the
Predictor's loaded npz, or a scope snapshot), because folding a
batch_norm into the preceding conv's weights is only meaningful once
the weights are numbers.

Legality: only test-mode batch_norms (``is_test`` /
``use_global_stats`` / a ``clone(for_test=True)`` program) fold — a
training BN's batch statistics depend on the activations and cannot be
folded into weights.  Math (matching the kernel's inference affine):

    a = gamma / sqrt(moving_var + eps)
    b = beta - a * moving_mean
    bn(conv(x, W))        == conv(x, W * a) + b      (channel axis)
    bn(x @ W [+ bias])    == x @ (W * a) [+ (a*bias + b)]

so a conv/fc that already carries a bias absorbs the fold completely
(one op removed); a bias-less one gains the ``+ b`` elementwise_add
unless ``b == 0`` exactly (fresh moving stats), keeping op count flat
at worst.
"""

import numpy as np

__all__ = ["fold_batch_norm", "fold_scale_chain"]


def _single(names):
    return names[0] if names and len(names) == 1 else None


def _only_consumer(consumers, name, idx):
    return consumers.get(name, []) == [idx]


def fold_batch_norm(rw):
    """Fold test-mode batch_norm ops into the affine producer feeding
    them.  Needs ``rw.params`` (concrete values); a rewriter without
    them reports 0 folds."""
    if rw.params is None:
        return {"folded": 0}
    ops = rw.ops
    consumers = rw.consumers()
    producer = rw.producers()
    multi = rw.multi_written()
    persist = rw.persist_names()
    scopes = rw.all_scope_names()
    params = rw.params
    remove = set()
    rename = {}
    folded = 0
    new_bias = 0
    for i, op in enumerate(ops):
        if op.type != "batch_norm":
            continue
        a = op.attrs
        if not (a.get("is_test") or a.get("use_global_stats")
                or rw.program._is_test):
            continue
        x = _single(op.inputs.get("X"))
        y = _single(op.outputs.get("Y"))
        pnames = [_single(op.inputs.get(s))
                  for s in ("Scale", "Bias", "Mean", "Variance")]
        if x is None or y is None or any(p is None or p not in params
                                         for p in pnames):
            continue
        if y in persist or y in rw.protected:
            # a fetched/protected BN output can't be renamed away; the
            # repurposed-add form would keep the name, but one uniform
            # rule is safer than three special cases
            continue
        if y in multi or x in multi:
            # WAW barrier: with `x`/`y` rewritten elsewhere, the
            # producer map and the rename are both write-ambiguous
            continue
        if x in rw.protected:
            # fetches/sub-block reads are consumers the consumer map
            # can't see — the fold CHANGES x's value (scaled weights /
            # absorbed bias), so a protected intermediate blocks it
            continue
        # running-stat outputs pass through unchanged in test mode;
        # SavedMean/SavedVariance must be unconsumed to drop them
        saved = [n for s in ("SavedMean", "SavedVariance")
                 for n in op.outputs.get(s, ())]
        if any(consumers.get(n) for n in saved):
            continue
        if not _only_consumer(consumers, x, i):
            continue
        p_idx = producer.get(x)
        if p_idx is None or p_idx in remove:
            continue
        # accept conv2d/mul directly, or through their bias
        # elementwise_add
        chain = [p_idx]
        p_op = ops[p_idx]
        bias_name = None
        if p_op.type == "elementwise_add":
            bias_name = _single(p_op.inputs.get("Y"))
            ax = _single(p_op.inputs.get("X"))
            if (bias_name is None or bias_name not in params
                    or ax is None or ax in multi
                    or ax in rw.protected
                    or not _only_consumer(consumers, ax, p_idx)):
                continue
            # only a per-channel bias folds: it must match the BN
            # gamma's shape (a positional (C,H,W) bias broadcasts the
            # channel scale wrongly); the broadcast-AXIS check happens
            # below, once the producer's rank is known.  All guards
            # run BEFORE any params mutation.
            gamma_name = _single(op.inputs.get("Scale"))
            if np.asarray(params[bias_name]).shape \
                    != np.asarray(params[gamma_name]).shape:
                continue
            p_idx2 = producer.get(ax)
            if p_idx2 is None or p_idx2 in remove:
                continue
            chain.append(p_idx2)
            p_op = ops[p_idx2]
        if p_op.type == "conv2d":
            w_name = _single(p_op.inputs.get("Filter"))
            w_axis = 0                      # filters: [O, I/g, kh, kw]
            # a (C,)-sized bias is per-CHANNEL only if the add aligns
            # it with the conv's channel dim (rank 4): dim 1 for NCHW,
            # trailing for NHWC — a same-sized bias added along H
            # (axis=2) is positional and must not fold
            nhwc = p_op.attrs.get("data_format") == "NHWC"
            ok_axes = (-1, 3) if nhwc else (1, -3)
        elif p_op.type == "mul":
            w_name = _single(p_op.inputs.get("Y"))
            w_axis = -1                     # fc weights: [K, N]
            ok_axes = (-1, 1)               # rank-2 trailing dim
        else:
            continue
        if bias_name is not None \
                and ops[chain[0]].attrs.get("axis", -1) not in ok_axes:
            continue
        if w_name is None or w_name not in params:
            continue
        # weight/bias shared with another op -> scaling it would change
        # the OTHER consumer too
        if not _only_consumer(consumers, w_name, chain[-1]):
            continue
        if bias_name is not None \
                and not _only_consumer(consumers, bias_name, chain[0]):
            continue

        gamma, beta, mean, var = (np.asarray(params[p]) for p in pnames)
        eps = float(a.get("epsilon", 1e-5))
        w = np.asarray(params[w_name])
        scale = gamma / np.sqrt(var + eps)
        shift = beta - scale * mean
        bshape = [1] * w.ndim
        bshape[w_axis] = scale.shape[0]
        params[w_name] = (w * scale.reshape(bshape)).astype(w.dtype)
        prov = tuple(scopes[k] for k in chain) + (scopes[i],)
        if bias_name is not None:
            bias = np.asarray(params[bias_name])
            params[bias_name] = (scale * bias + shift).astype(bias.dtype)
            remove.add(i)
            rename[y] = x
            keeper = ops[chain[0]]
        elif not np.any(shift):
            remove.add(i)
            rename[y] = x
            keeper = ops[chain[-1]]
        else:
            # repurpose the bn op into the residual "+ b" channel add
            data_layout = a.get("data_layout", "NCHW")
            fold_name = y + ".bn_fold_bias"
            rw.make_constant(fold_name, shift.astype(w.dtype))
            params[fold_name] = shift.astype(w.dtype)
            op.type = "elementwise_add"
            op.inputs = {"X": [x], "Y": [fold_name]}
            op.outputs = {"Out": [y]}
            op.attrs = {"axis": 1 if data_layout in ("NCHW", "AnyLayout")
                        else -1}
            new_bias += 1
            keeper = op
        keeper.folded_from = getattr(keeper, "folded_from", ()) + prov
        folded += 1
    if remove or rename:
        rw.apply(remove=remove, rename=rename)
    elif new_bias:
        rw.program._bump()
    return {"folded": folded, "bias_adds_added": new_bias}


def fold_scale_chain(rw):
    """Collapse scale(scale(x)) chains into one scale op:
    ``s2*(s1*x + b1) + b2 == (s1*s2)*x + (s2*b1 + b2)`` for the default
    bias_after_scale form.  Value-free (attrs only)."""
    ops = rw.ops
    consumers = rw.consumers()
    producer = rw.producers()
    multi = rw.multi_written()
    persist = rw.persist_names()
    scopes = rw.all_scope_names()
    remove = set()
    rename = {}
    collapsed = 0
    for i, op in enumerate(ops):
        if op.type != "scale" \
                or not op.attrs.get("bias_after_scale", True):
            continue
        x = _single(op.inputs.get("X"))
        if x is None or x in multi:     # WAW: first-producer ambiguous
            continue
        j = producer.get(x)
        if j is None or j >= i or j in remove:
            continue
        inner = ops[j]
        if inner.type != "scale" \
                or not inner.attrs.get("bias_after_scale", True):
            continue
        if not _only_consumer(consumers, x, i):
            continue
        if x in rw.protected or x in persist:
            continue
        # the collapse MOVES the inner scale's input read from position
        # j to position i; a WAW rewrite of that input in between would
        # hand the moved read the wrong write
        u = _single(inner.inputs.get("X"))
        if u is None or u in multi:
            continue
        s1 = float(inner.attrs.get("scale", 1.0))
        b1 = float(inner.attrs.get("bias", 0.0))
        s2 = float(op.attrs.get("scale", 1.0))
        b2 = float(op.attrs.get("bias", 0.0))
        op.inputs = {"X": list(inner.inputs.get("X", []))}
        op.attrs = dict(op.attrs)
        op.attrs["scale"] = s1 * s2
        op.attrs["bias"] = s2 * b1 + b2
        op.folded_from = getattr(op, "folded_from", ()) + (scopes[j],)
        remove.add(j)
        collapsed += 1
    if remove:
        rw.apply(remove=remove, rename=rename)
    return {"collapsed": collapsed}
