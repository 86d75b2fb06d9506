"""Fusion pass tier — pattern-match Program subgraphs into the fused
ops whose kernels dispatch to ``paddle_tpu_torch/kernels/``.

Port of paddle_tpu/passes/fuse.py (pure Python, the same matchers and
guards, so a fused Program is ``to_json`` byte-equal to the reference's).
Four subgraph matchers over the (cloned) Program:

- ``fuse_attention``  — matmul(Q,K^T) · scale · [+mask] · softmax ·
                        matmul(·,V), optionally absorbing the zoo's
                        split-heads reshape/transpose ring, into ONE
                        ``fused_attention`` op (K1-K3 on the card).
- ``fuse_bottleneck`` — conv2d → batch_norm [→ act] into
                        ``fused_bottleneck`` (training-capable: the
                        running-stat updates ride along).
- ``fuse_bias_act``   — elementwise_add(X, bias-param) → activation
                        into ``fused_bias_act`` (the fc/conv epilogue).
- ``fuse_layer_norm`` — elementwise_add(x, residual) → layer_norm into
                        ``fused_layer_norm``.

AMP transparency: every pattern edge is resolved THROUGH the cast ops
``amp.rewrite_program`` inserts (a sole-consumed cast is absorbed and
the dtype it produced recorded as the fused op's ``compute_dtype``), so
fusion fires on the bf16 graph exactly as it does on fp32 — the
canonical order is AMP rewrite → fusion → structural passes, enforced
by ``amp.rewrite_program`` refusing programs that already carry
fusion-tier ops.

Every rewrite repurposes the pattern's LAST op in place (its output
name — what downstream reads — never changes) and removes the rest
through :meth:`ProgramRewriter.apply`; ``folded_from`` records the
ABSORBED ops' scope names plus the anchor's own pre-rewrite scope, so
op-profile attribution maps fused device time back to the source
scopes.  Patterns never straddle a BackwardSection boundary (ops on
opposite sides trace into different value_and_grad closures).
"""

from ..analysis import facts as _facts

__all__ = ["fuse_attention", "fuse_bias_act", "fuse_bottleneck",
           "fuse_layer_norm", "FUSED_TIER_TYPES"]

# the op types this tier emits — amp.rewrite_program refuses programs
# carrying them (AMP must run BEFORE fusion)
FUSED_TIER_TYPES = frozenset((
    "fused_attention", "fused_bias_act", "fused_layer_norm",
    "fused_bottleneck"))

# activations the bias-act / bottleneck matchers absorb (each a
# registered single-input kernel with an {"X"} -> {"Out"} contract)
_FUSABLE_ACTS = ("relu", "gelu", "tanh", "sigmoid")


class _Match:
    """Shared bookkeeping for one fusion pass run: consumer/producer
    maps, segment assignment, the used-index set keeping patterns
    disjoint, the PRE-rewrite scope names for provenance, the
    cast-transparent edge walkers, and the shared EXPLAIN mode: every
    guard that can refuse an otherwise-structurally-matched pattern is
    NAMED, records which op/var it fired on into ``last_guard``, and a
    matcher that bails on a guard calls :meth:`miss` so the near-miss
    (pattern, anchor, guard, detail) lands in ``near_misses`` — what
    the PT406 lint renders and ``passes.fuse_program`` aggregates onto
    ``program._fusion_near_misses``."""

    def __init__(self, rw, pattern=None):
        self.rw = rw
        self.pattern = pattern
        self.near_misses = []
        # (guard name, op index or None, detail) of the most recent
        # guard refusal; cleared at each anchor and consumed by miss()
        self.last_guard = None
        self.ops = rw.ops
        self.cons = rw.consumers()
        self.prod = rw.producers()
        self.persist = rw.persist_names()
        self.multi = rw.multi_written()
        self.specs = rw.specs()
        # scope names BEFORE any anchor mutation: what folded_from must
        # record (the anchor's own scope changes with its new type)
        self.scopes0 = rw.all_scope_names()
        self.seg_of = _facts.backward_segments(len(self.ops),
                                               rw.sections())
        self.used = set()
        self.remove = set()
        self.matched = 0

    # -- guards (each refusal is NAMED for the PT406 explain mode) ----
    def fail(self, guard, detail, at=None, var=None):
        """Record one named guard refusal and return False — the one
        bail-out path every guard shares, so 'which guard fired on
        which op' (and which VARIABLE, when one is to blame) is a fact
        the matcher records, not a reconstruction."""
        self.last_guard = (guard, at, detail, var)
        return False

    def internal_ok(self, name, inside):
        """`name` may vanish inside a fused region: every consumer is
        in `inside`, and nothing outside the rewrite can see it."""
        at = self.prod.get(name)
        if name in self.rw.protected:
            return self.fail(
                "protected_var",
                f"intermediate '{name}' is protected (fetched or "
                f"referenced from a control-flow body)", at, var=name)
        if name in self.persist:
            return self.fail(
                "persistable_intermediate",
                f"intermediate '{name}' is persistable state", at,
                var=name)
        if name in self.multi:
            return self.fail(
                "multi_write",
                f"intermediate '{name}' is written more than once "
                f"(WAW barrier)", at, var=name)
        if name in self.rw.feed_names:
            return self.fail("fed_intermediate",
                             f"intermediate '{name}' is a feed", at,
                             var=name)
        outside = [c for c in self.cons.get(name, ())
                   if c not in inside]
        if outside:
            return self.fail(
                "multi_consumer",
                f"intermediate '{name}' has {len(outside)} "
                f"consumer(s) outside the pattern (first: op "
                f"#{outside[0]} '{self.ops[outside[0]].type}')", at,
                var=name)
        return True

    def side_outs_dead(self, i, keep_slots=("Out", "Y")):
        """Secondary outputs (XShape markers) of an op being absorbed
        must be unconsumed and invisible."""
        op = self.ops[i]
        for slot, names in op.outputs.items():
            if slot in keep_slots:
                continue
            for n in names:
                if self.cons.get(n) or n in self.rw.protected \
                        or n in self.persist:
                    return self.fail(
                        "live_side_output",
                        f"op #{i} '{op.type}' side output '{n}' "
                        f"({slot}) is consumed or protected", i,
                        var=n)
        return True

    def absorbable(self, i):
        if i is None:
            return False
        if i in self.used or i in self.remove:
            return self.fail(
                "already_fused",
                f"op #{i} '{self.ops[i].type}' was already absorbed "
                f"by an earlier pattern", i)
        return True

    def same_seg(self, idxs):
        if len({self.seg_of[i] for i in idxs}) == 1:
            return True
        lo = min(idxs)
        return self.fail(
            "section_boundary",
            f"pattern ops {sorted(idxs)} straddle a backward-section "
            f"boundary (opposite sides trace into different "
            f"value_and_grad closures)", lo)

    def miss(self, anchor):
        """The structural pattern anchored at `anchor` matched, but
        the most recent named guard refused it: record the near-miss
        (a no-op when the bail was structural — no guard fired)."""
        if self.last_guard is None:
            return
        guard, at, detail, var = self.last_guard
        self.last_guard = None
        op = self.ops[anchor]
        self.near_misses.append({
            "pattern": self.pattern,
            "anchor_type": op.type,
            "callsite": getattr(op, "callsite", None),
            "guard": guard,
            "detail": detail,
            "var": var,
            # op OBJECTS, not indices: later patterns/passes shift the
            # op list, and fuse_program resolves final indices by
            # identity once every pass has run
            "_anchor_op": op,
            "_guard_op": None if at is None else self.ops[at],
        })

    # -- cast-transparent edges ---------------------------------------
    def up(self, name, casts):
        """Resolve `name` UP through producer casts that nothing else
        consumes, collecting their indices into `casts`.  Returns
        (resolved_name, immediate_dtype) — the dtype the consuming op
        actually saw, which is how the matcher learns AMP's compute
        dtype."""
        imm = self._dtype(name)
        while True:
            j = self.prod.get(name)
            saved = self.last_guard
            if not self.absorbable(j):
                # probing, not a refusal: the edge stays matchable on
                # this name — an `already_fused` probe here must not
                # masquerade as the guard a LATER structural bail hit
                self.last_guard = saved
                return name, imm
            op = self.ops[j]
            if op.type != "cast":
                return name, imm
            out = op.outputs["Out"][0]
            if len(self.cons.get(out, ())) != 1 \
                    or out in self.rw.protected or out in self.persist \
                    or out in self.multi:
                # the cast feeds something else too: the edge stays on
                # the cast's out (still matchable, cast not absorbed)
                return name, imm
            casts.append(j)
            name = op.inputs["X"][0]

    def sole_consumer(self, name, casts, want_types):
        """The single op consuming `name` (walking DOWN through
        sole-consumed casts), or None.  `want_types` filters the final
        op's type."""
        while True:
            cs = [c for c in self.cons.get(name, ())]
            if len(cs) > 1:
                return self.fail(
                    "multi_consumer",
                    f"'{name}' has {len(cs)} consumers; the pattern "
                    f"needs it sole-consumed to absorb the edge",
                    cs[0], var=name) or None
            if len(cs) != 1 or not self.absorbable(cs[0]):
                return None
            op = self.ops[cs[0]]
            if op.type == "cast":
                out = op.outputs["Out"][0]
                if out in self.rw.protected or out in self.persist \
                        or out in self.multi:
                    return self.fail(
                        "shared_cast",
                        f"cast output '{out}' (op #{cs[0]}) is "
                        f"protected, persistable, or rewritten — the "
                        f"cast cannot be absorbed into the pattern",
                        cs[0], var=out) or None
                casts.append(cs[0])
                name = out
                continue
            return cs[0] if op.type in want_types else None

    def _dtype(self, name):
        spec = self.specs.get(name)
        return getattr(spec, "dtype", None)

    def cast_target(self, cast_idxs):
        """The low-precision dtype an ABSORBED input cast produced —
        what the fused op must re-apply as its compute_dtype.  "" when
        no absorbed cast targeted a low-precision dtype (the inputs
        arrive in their own dtype — possibly already bf16 when a
        shared, non-absorbed cast feeds them; the kernel then computes
        in that dtype with no extra cast)."""
        for j in cast_idxs:
            to = str(self.ops[j].attrs.get("out_dtype") or "")
            if to in ("bfloat16", "float16"):
                return to
        return ""

    def commit(self, anchor, absorbed):
        """One pattern done: record provenance from the PRE-rewrite
        scopes (absorbed ops + the anchor's own former identity), mark
        indices used, schedule removals."""
        a_op = self.ops[anchor]
        prov = tuple(self.scopes0[g] for g in sorted(absorbed)) \
            + (self.scopes0[anchor],)
        a_op.folded_from = tuple(getattr(a_op, "folded_from", ())) + prov
        self.used.add(anchor)
        self.used.update(absorbed)
        self.remove.update(absorbed)
        self.matched += 1

    def finish(self):
        removed = self.rw.apply(remove=self.remove)
        self.rw.sweep_dead_vars()
        stats = {"matched": self.matched, "absorbed_ops": removed}
        if self.near_misses:
            # carries live op refs — fuse_program pops this key,
            # resolves final indices, and keeps the telemetry row
            # JSON-clean
            stats["near_misses"] = self.near_misses
        return stats


# ---------------------------------------------------------------------------
# (a) attention
# ---------------------------------------------------------------------------

def _match_split_ring(m, name, edge_consumers):
    """Walk UP through the zoo's split-heads pair —
    transpose2([0,2,1,3]) ← reshape2([.., t, h, hd]) — returning
    (source_name, heads, absorbed_indices) or None."""
    j = m.prod.get(name)
    if not m.absorbable(j):
        return None
    tr = m.ops[j]
    if tr.type != "transpose2" \
            or list(tr.attrs.get("axis", ())) != [0, 2, 1, 3]:
        return None
    if not m.internal_ok(tr.outputs["Out"][0], edge_consumers) \
            or not m.side_outs_dead(j):
        return None
    k = m.prod.get(tr.inputs["X"][0])
    if not m.absorbable(k):
        return None
    rs = m.ops[k]
    if rs.type != "reshape2" or rs.inputs.get("ShapeTensor"):
        return None
    target = list(rs.attrs.get("shape", ()))
    if len(target) != 4:
        return None
    heads = target[2]
    if not isinstance(heads, int) or heads <= 0:
        return None
    if not m.internal_ok(rs.outputs["Out"][0], {j}) \
            or not m.side_outs_dead(k):
        return None
    return rs.inputs["X"][0], heads, [j, k]


def fuse_attention(rw):
    """matmul·scale·[mask]·softmax·matmul → ``fused_attention``."""
    m = _Match(rw, "fuse_attention")
    for i, op in enumerate(m.ops):
        m.last_guard = None
        if op.type != "softmax" or not m.absorbable(i):
            continue
        spec = m.specs.get(op.inputs["X"][0])
        rank = (len(spec.shape) if spec is not None
                and spec.shape is not None else None)
        axis = op.attrs.get("axis", -1)
        if axis not in (-1, None) and (rank is None or axis != rank - 1):
            continue
        casts_up = []
        sm_in, _ = m.up(op.inputs["X"][0], casts_up)
        j = m.prod.get(sm_in)
        if not m.absorbable(j):
            m.miss(i)
            continue
        # optional additive mask between scale and softmax
        mask_name = None
        mask_idx = None
        cand = m.ops[j]
        if cand.type == "elementwise_add":
            if cand.attrs.get("axis", -1) != -1:
                # reference axis semantics reshape Y before adding; the
                # fused kernel applies plain trailing-dim broadcast, so
                # only that form is the same computation
                continue
            mask_name = cand.inputs["Y"][0]
            mask_idx = j
            nxt, _ = m.up(cand.inputs["X"][0], casts_up)
            j = m.prod.get(nxt)
            if not m.absorbable(j):
                m.miss(i)
                continue
            cand = m.ops[j]
        if cand.type != "scale" \
                or float(cand.attrs.get("bias", 0.0)) != 0.0:
            continue
        scale_idx = j
        scale_val = float(cand.attrs.get("scale", 1.0))
        mm1_in, _ = m.up(cand.inputs["X"][0], casts_up)
        j = m.prod.get(mm1_in)
        if not m.absorbable(j):
            m.miss(i)
            continue
        mm1 = m.ops[j]
        if mm1.type != "matmul" \
                or mm1.attrs.get("transpose_X", False) \
                or not mm1.attrs.get("transpose_Y", False):
            continue
        mm1_idx = j
        scale_val *= float(mm1.attrs.get("alpha", 1.0))
        # downstream: softmax -> (casts) -> matmul2 with probs as X
        casts_down = []
        mm2_idx = m.sole_consumer(op.outputs["Out"][0], casts_down,
                                  ("matmul",))
        if mm2_idx is None:
            m.miss(i)
            continue
        mm2 = m.ops[mm2_idx]
        if mm2.attrs.get("transpose_X", False) \
                or mm2.attrs.get("transpose_Y", False) \
                or float(mm2.attrs.get("alpha", 1.0)) != 1.0:
            continue
        probs_chain = {op.outputs["Out"][0]}
        probs_chain.update(m.ops[c].outputs["Out"][0]
                           for c in casts_down)
        if mm2.inputs["X"][0] not in probs_chain:
            continue
        core = {mm1_idx, scale_idx, i, mm2_idx}
        if mask_idx is not None:
            core.add(mask_idx)
        if not m.same_seg(core):
            m.miss(i)
            continue
        inside = core | set(casts_up) | set(casts_down)
        mids = [mm1.outputs["Out"][0],
                m.ops[scale_idx].outputs["Out"][0],
                op.outputs["Out"][0]]
        if mask_idx is not None:
            mids.append(m.ops[mask_idx].outputs["Out"][0])
        mids.extend(m.ops[c].outputs["Out"][0]
                    for c in casts_up + casts_down)
        if not all(m.internal_ok(n, inside) for n in mids):
            m.miss(i)
            continue
        # Q/K/V edges (through AMP casts); the immediate dtype the
        # anchor matmul computed in is the fused op's compute dtype
        q_casts, k_casts, v_casts = [], [], []
        q_name, _ = m.up(mm1.inputs["X"][0], q_casts)
        k_name, _ = m.up(mm1.inputs["Y"][0], k_casts)
        v_name, _ = m.up(mm2.inputs["Y"][0], v_casts)
        compute = m.cast_target(q_casts + k_casts + v_casts)
        # optional full ring: split-heads on Q/K/V + merge after mm2
        heads = 0
        ring = []
        anchor = mm2_idx
        out_name = mm2.outputs["Out"][0]
        rq = _match_split_ring(
            m, q_name, {mm1_idx} | set(q_casts))
        rk = _match_split_ring(
            m, k_name, {mm1_idx} | set(k_casts))
        rv = _match_split_ring(
            m, v_name, {mm2_idx} | set(v_casts))
        merge = None
        if rq and rk and rv and rq[1] == rk[1] == rv[1]:
            tr_c = []
            tr_idx = m.sole_consumer(out_name, tr_c, ("transpose2",))
            if tr_idx is not None and not tr_c \
                    and list(m.ops[tr_idx].attrs.get("axis", ())) == \
                    [0, 2, 1, 3] and m.side_outs_dead(tr_idx):
                rs_c = []
                rs_idx = m.sole_consumer(
                    m.ops[tr_idx].outputs["Out"][0], rs_c,
                    ("reshape2",))
                if rs_idx is not None and not rs_c \
                        and len(m.ops[rs_idx].attrs.get(
                            "shape", ())) == 3 \
                        and not m.ops[rs_idx].inputs.get(
                            "ShapeTensor") \
                        and m.side_outs_dead(rs_idx) \
                        and m.internal_ok(
                            m.ops[tr_idx].outputs["Out"][0],
                            {rs_idx}) \
                        and m.internal_ok(out_name, {tr_idx}):
                    merge = (tr_idx, rs_idx)
        if merge is not None:
            heads = rq[1]
            q_name, k_name, v_name = rq[0], rk[0], rv[0]
            ring = rq[2] + rk[2] + rv[2] + [merge[0], mm2_idx]
            anchor = merge[1]
            out_name = m.ops[anchor].outputs["Out"][0]
            if not m.same_seg(core | set(ring) | {anchor}):
                m.miss(i)
                continue
        absorbed = (core | set(casts_up) | set(casts_down)
                    | set(q_casts) | set(k_casts) | set(v_casts)
                    | set(ring)) - {anchor}
        a_op = m.ops[anchor]
        m.commit(anchor, absorbed)
        a_op.type = "fused_attention"
        a_op.inputs = {"Q": [q_name], "K": [k_name], "V": [v_name]}
        if mask_name is not None:
            a_op.inputs["Mask"] = [mask_name]
        a_op.outputs = {"Out": [out_name]}
        a_op.attrs = {"scale": scale_val, "head_number": heads,
                      "compute_dtype": compute, "softmax_axis": -1}
        # decode-shaped match (q_len == 1 against a longer K/V prefix):
        # tag it so the kernel's single-query dispatch (fused_ops ->
        # kernels.attention.decode_attention / flash_decode) is visible
        # statically — in the pass report and the numerics analyzer —
        # not just a runtime shape branch.  Both the pre-split
        # [B, T, H*D] ring form and the head-split [B, H, S, D] form
        # carry the sequence length at axis -2.
        q_spec = m.specs.get(q_name)
        k_spec = m.specs.get(k_name)
        if (q_spec is not None and q_spec.shape is not None
                and k_spec is not None and k_spec.shape is not None
                and len(q_spec.shape) >= 2 and len(k_spec.shape) >= 2
                and q_spec.shape[-2] == 1 and k_spec.shape[-2]
                and k_spec.shape[-2] > 1):
            a_op.attrs["decode"] = True
    return m.finish()


# ---------------------------------------------------------------------------
# (b) bias + activation
# ---------------------------------------------------------------------------

def fuse_bias_act(rw):
    """elementwise_add(X, bias-parameter) → act ⇒ ``fused_bias_act``."""
    m = _Match(rw, "fuse_bias_act")
    params = {v.name for v in rw.program.list_vars() if v.is_parameter}
    for i, op in enumerate(m.ops):
        m.last_guard = None
        if op.type not in _FUSABLE_ACTS or not m.absorbable(i):
            continue
        casts = []
        x_in, _ = m.up(op.inputs["X"][0], casts)
        j = m.prod.get(x_in)
        if not m.absorbable(j):
            m.miss(i)
            continue
        add = m.ops[j]
        if add.type != "elementwise_add":
            continue
        bias = add.inputs["Y"][0]
        bspec = m.specs.get(bias)
        if bias not in params or bspec is None \
                or bspec.shape is None or len(bspec.shape) != 1:
            continue
        if not m.same_seg({i, j}):
            m.miss(i)
            continue
        inside = {i, j} | set(casts)
        mids = [add.outputs["Out"][0]] \
            + [m.ops[c].outputs["Out"][0] for c in casts]
        if not all(m.internal_ok(n, inside) for n in mids):
            m.miss(i)
            continue
        a_op = m.ops[i]
        m.commit(i, {j} | set(casts))
        a_op.attrs = {"act": a_op.type,
                      # the act op's own attrs ride along verbatim
                      # (gelu approximate=True must stay approximate)
                      "act_attrs": dict(a_op.attrs),
                      "axis": add.attrs.get("axis", -1)}
        a_op.type = "fused_bias_act"
        a_op.inputs = {"X": [add.inputs["X"][0]], "Bias": [bias]}
    return m.finish()


# ---------------------------------------------------------------------------
# (c) layer_norm ± residual
# ---------------------------------------------------------------------------

def fuse_layer_norm(rw):
    """elementwise_add(x, residual) → layer_norm ⇒ ``fused_layer_norm``."""
    m = _Match(rw, "fuse_layer_norm")
    for i, op in enumerate(m.ops):
        m.last_guard = None
        if op.type != "layer_norm" or not m.absorbable(i):
            continue
        casts = []
        x_in, _ = m.up(op.inputs["X"][0], casts)
        j = m.prod.get(x_in)
        if not m.absorbable(j):
            m.miss(i)
            continue
        add = m.ops[j]
        if add.type != "elementwise_add" \
                or add.attrs.get("axis", -1) != -1:
            continue
        xs = m.specs.get(add.inputs["X"][0])
        ys = m.specs.get(add.inputs["Y"][0])
        if xs is None or ys is None or xs.shape is None \
                or ys.shape is None or len(xs.shape) != len(ys.shape):
            continue          # only the same-rank residual form
        if not m.same_seg({i, j}):
            m.miss(i)
            continue
        inside = {i, j} | set(casts)
        mids = [add.outputs["Out"][0]] \
            + [m.ops[c].outputs["Out"][0] for c in casts]
        if not all(m.internal_ok(n, inside) for n in mids):
            m.miss(i)
            continue
        a_op = m.ops[i]
        m.commit(i, {j} | set(casts))
        a_op.type = "fused_layer_norm"
        new_ins = {"X": [add.inputs["X"][0]],
                   "Residual": [add.inputs["Y"][0]]}
        for slot in ("Scale", "Bias"):
            if a_op.inputs.get(slot):
                new_ins[slot] = a_op.inputs[slot]
        a_op.inputs = new_ins
    return m.finish()


# ---------------------------------------------------------------------------
# (d) conv + batch_norm (+ act)
# ---------------------------------------------------------------------------

def fuse_bottleneck(rw):
    """conv2d → batch_norm [→ act] ⇒ ``fused_bottleneck`` (stateful:
    the running-stat writes ride along — the fused op keeps the bn op's
    MeanOut/VarianceOut aliasing, so the PT106 donation lint holds)."""
    m = _Match(rw, "fuse_bottleneck")
    for i, op in enumerate(m.ops):
        m.last_guard = None
        if op.type != "batch_norm" or not m.absorbable(i):
            continue
        casts = []
        x_in, _ = m.up(op.inputs["X"][0], casts)
        j = m.prod.get(x_in)
        if not m.absorbable(j):
            m.miss(i)
            continue
        conv = m.ops[j]
        if conv.type != "conv2d":
            continue
        conv_out = conv.outputs["Output"][0]
        # optional trailing activation on bn's Y
        act_casts = []
        act_idx = m.sole_consumer(op.outputs["Y"][0], act_casts,
                                  _FUSABLE_ACTS)
        if act_idx is not None and not act_casts \
                and m.same_seg({i, j, act_idx}):
            anchor = act_idx
            act = m.ops[act_idx].type
            act_attrs = dict(m.ops[act_idx].attrs)
            out_name = m.ops[act_idx].outputs["Out"][0]
            absorbed = {i, j} | set(casts)
            mids = [conv_out, op.outputs["Y"][0]]
        else:
            if not m.same_seg({i, j}):
                m.miss(i)
                continue
            anchor = i
            act = ""
            act_attrs = {}
            out_name = op.outputs["Y"][0]
            absorbed = {j} | set(casts)
            mids = [conv_out]
        inside = absorbed | {anchor}
        mids.extend(m.ops[c].outputs["Out"][0] for c in casts)
        if not all(m.internal_ok(n, inside) for n in mids):
            m.miss(anchor)
            continue
        if anchor != i:
            # the bn op's stat outputs move to the anchor, which sits
            # LATER in the op list — any consumer between bn and the
            # anchor would read them before production
            ok = True
            for slot, names in op.outputs.items():
                if slot == "Y":
                    continue
                for n in names:
                    if any(c <= anchor and c != i and c not in inside
                           for c in m.cons.get(n, ())):
                        ok = False
                        m.fail(
                            "stat_consumer_order",
                            f"batch_norm stat output '{n}' is read "
                            f"between the bn (op #{i}) and the fused "
                            f"anchor (op #{anchor}); moving the stat "
                            f"write to the anchor would reorder that "
                            f"read", i, var=n)
            if not ok:
                m.miss(anchor)
                continue
        in_casts, f_casts = [], []
        in_name, _ = m.up(conv.inputs["Input"][0], in_casts)
        f_name, _ = m.up(conv.inputs["Filter"][0], f_casts)
        compute = m.cast_target(in_casts + f_casts)
        absorbed |= set(in_casts) | set(f_casts)
        bn_outs = {k: list(v) for k, v in op.outputs.items()}
        bn_ins = {k: list(v) for k, v in op.inputs.items()}
        bn_attrs = dict(op.attrs)
        a_op = m.ops[anchor]
        m.commit(anchor, absorbed)
        a_op.type = "fused_bottleneck"
        a_op.inputs = {"Input": [in_name], "Filter": [f_name],
                       "Scale": bn_ins["Scale"], "Bias": bn_ins["Bias"],
                       "Mean": bn_ins["Mean"],
                       "Variance": bn_ins["Variance"]}
        outs = {"Y": [out_name]}
        for slot in ("MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"):
            if bn_outs.get(slot):
                outs[slot] = bn_outs[slot]
        a_op.outputs = outs
        a_op.attrs = {"conv_attrs": dict(conv.attrs),
                      "bn_attrs": bn_attrs, "act": act,
                      "act_attrs": act_attrs,
                      "compute_dtype": compute}
    return m.finish()
