"""paddle_tpu_torch.passes — the fusion tier of the graph optimizer
(port of the fusion half of paddle_tpu/passes/__init__.py).

`fuse_program` rewrites a (cloned) Program through the four fusion
matchers of `fuse.py`, in `FUSION_PIPELINE` order, and returns it with a
``kind="pass_pipeline"`` report tagged ``tier="fusion"``: per-pass
before/after op counts, wall time and pattern match counts, plus the
near-misses (patterns a named guard refused).

The structural tier of the reference (`common.py`: const_fold, cse,
identity_elim, dce; `fold.py`: the scale-chain and batch-norm folds),
`optimize_program`, `fold_inference` and FLAGS_graph_opt are ROADMAP
item 10; nothing in the fusion tier needs them.

Entry point::

    fused, report = passes.fuse_program(main, fetch_names=[loss.name])

Executor integration: FLAGS_graph_opt_fuse=on substitutes the fused
program for every executor-run train program (cached per version, fetch
set and pass config; see `Executor._resolve_train_optimized`).
"""

import time

from .. import flags
from .fuse import (FUSED_TIER_TYPES, fuse_attention, fuse_bias_act,
                   fuse_bottleneck, fuse_layer_norm)
from .rewriter import ProgramRewriter

__all__ = ["PASSES", "FUSION_PIPELINE", "FUSED_TIER_TYPES",
           "fuse_program", "enabled_fusion_passes", "ProgramRewriter"]

PASSES = {
    "fuse_attention": fuse_attention,
    "fuse_bottleneck": fuse_bottleneck,
    "fuse_bias_act": fuse_bias_act,
    "fuse_layer_norm": fuse_layer_norm,
}

# fusion tier order: attention first (the biggest subgraph — bias_act
# firing first would not overlap it, but keeping the large pattern
# greedy is the cheap way to never have a small fuse shadow a big one),
# then the conv+bn bottleneck, then the epilogue/residual pairs
FUSION_PIPELINE = ("fuse_attention", "fuse_bottleneck",
                   "fuse_bias_act", "fuse_layer_norm")


def enabled_fusion_passes(disable=None):
    """The fusion pipeline minus ``disable`` (an iterable of names, or
    None to read ``FLAGS_graph_opt_fuse_disable`` — comma-separated)."""
    if disable is None:
        disable = flags.flag("graph_opt_fuse_disable")
    if isinstance(disable, str):
        disable = [p.strip() for p in disable.split(",") if p.strip()]
    disable = set(disable)
    unknown = disable - set(FUSION_PIPELINE)
    if unknown:
        raise KeyError(
            f"unknown fusion pass(es) {sorted(unknown)}; known: "
            f"{list(FUSION_PIPELINE)}")
    return tuple(p for p in FUSION_PIPELINE if p not in disable)


def fuse_program(program, fetch_names=(), feed_names=(), clone=True,
                 disable=None, program_key=None, record=True):
    """Run the fusion tier over `program` and return
    ``(fused_program, report)``.

    clone=True (the default) rewrites a clone; clone=False rewrites
    `program` itself — the executor's train-tier path, which has already
    cloned (AMP rewrite → fusion run on the same private substitute,
    preserving the canonical order).

    The report is a ``kind="pass_pipeline"`` record tagged
    ``tier="fusion"`` whose per-pass rows carry the pattern match counts
    (``matched``).  `record` is accepted for the reference's signature
    and records nothing: the reference appends the report to its
    telemetry stream (`monitor`, ROADMAP item 10), which does nothing
    while telemetry is off."""
    names = enabled_fusion_passes(disable)
    t0 = time.perf_counter()
    opt = program.clone(for_test=program._is_test) if clone else program
    rw = ProgramRewriter(opt, fetch_names=fetch_names,
                         feed_names=feed_names)
    before = len(rw.ops)
    rows = []
    raw_misses = []
    for name in names:
        stats = rw.timed(PASSES[name])
        stats["name"] = name
        # near-miss records carry live op refs (indices shift as the
        # passes rewrite) — pull them out of the row and resolve below,
        # once every pass has run
        raw_misses.extend(stats.pop("near_misses", ()))
        rows.append(stats)
    opt._fusion_applied = True
    # resolve near-misses against the FINAL op list: an anchor a later
    # pattern absorbed or repurposed is moot; the rest get their op index
    final_pos = {id(op): k for k, op in
                 enumerate(opt.global_block().ops)}
    near_misses = []
    for nm in raw_misses:
        a_op = nm.pop("_anchor_op", None)
        g_op = nm.pop("_guard_op", None)
        ai = final_pos.get(id(a_op))
        if ai is None or a_op.type != nm.get("anchor_type"):
            continue
        nm["anchor_index"] = ai
        gi = final_pos.get(id(g_op)) if g_op is not None else None
        nm["guard_op_index"] = ai if gi is None else gi
        near_misses.append(nm)
    opt._fusion_near_misses = near_misses
    report = {
        "kind": "pass_pipeline",
        "tier": "fusion",
        "key": program_key or "prog%x:v%d" % (id(program),
                                              program._version),
        "before_ops": before,
        "after_ops": len(rw.ops),
        "ops_removed": before - len(rw.ops),
        "patterns_matched": sum(r.get("matched", 0) for r in rows),
        "passes": rows,
        "total_wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
    }
    if near_misses:
        guards = {}
        for nm in near_misses:
            g = nm.get("guard") or "?"
            guards[g] = guards.get(g, 0) + 1
        report["near_misses"] = len(near_misses)
        report["near_miss_guards"] = dict(sorted(guards.items()))
    return opt, report
