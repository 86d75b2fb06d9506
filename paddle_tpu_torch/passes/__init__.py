"""paddle_tpu_torch.passes — the program-level graph optimizer (port of
paddle_tpu/passes/__init__.py).

Ordered pipelines that rewrite a recorded Program (a new `_version`, so
every cache re-keys), each with a ``kind="pass_pipeline"`` report of
per-pass op counts and wall time:

- the structural tier, `DEFAULT_PIPELINE` (`common.py`: const_fold, cse,
  identity_elim, dce; `fold.py`: fold_scale_chain, fold_batch_norm,
  which needs parameter values): `optimize_program`, and
  `fold_inference`, the Predictor's load-time path
  (FLAGS_inference_fold);
- the fusion tier, `FUSION_PIPELINE` (`fuse.py`): `fuse_program`, which
  rewrites attention, bottleneck, bias+activation and residual+LayerNorm
  patterns into the fused ops (`ops/fused_ops.py`).

Entry points::

    opt, report = passes.optimize_program(main, fetch_names=[loss.name])
    opt, params, report = passes.fold_inference(program, params, fetches)
    fused, report = passes.fuse_program(main, fetch_names=[loss.name])

Executor integration: FLAGS_graph_opt_fuse=on substitutes the fused
program for every executor-run train program (cached per version, fetch
set and pass config; see `Executor._resolve_train_optimized`).  The
Executor's FLAGS_graph_opt substitution of the structural tier is
ROADMAP item 10.  `record` is accepted for the reference's signature and
records nothing: the reference appends each report to its telemetry
stream (`monitor`, ROADMAP item 10), which does nothing while telemetry
is off.
"""

import time

from .. import flags
from .common import const_fold, cse, dce, identity_elim
from .fold import fold_batch_norm, fold_scale_chain
from .fuse import (FUSED_TIER_TYPES, fuse_attention, fuse_bias_act,
                   fuse_bottleneck, fuse_layer_norm)
from .rewriter import ProgramRewriter

__all__ = ["PASSES", "DEFAULT_PIPELINE", "FUSION_PIPELINE",
           "FUSED_TIER_TYPES", "optimize_program", "fuse_program",
           "fold_inference", "enabled_passes", "enabled_fusion_passes",
           "ProgramRewriter"]

PASSES = {
    "const_fold": const_fold,
    "cse": cse,
    "identity_elim": identity_elim,
    "fold_scale_chain": fold_scale_chain,
    "fold_batch_norm": fold_batch_norm,
    "dce": dce,
    "fuse_attention": fuse_attention,
    "fuse_bottleneck": fuse_bottleneck,
    "fuse_bias_act": fuse_bias_act,
    "fuse_layer_norm": fuse_layer_norm,
}

# order matters: folding creates constants/identities the later passes
# clean up, and dce runs last to sweep every orphaned producer
DEFAULT_PIPELINE = ("const_fold", "cse", "identity_elim",
                    "fold_scale_chain", "fold_batch_norm", "dce")

# fusion tier order: attention first (the biggest subgraph — bias_act
# firing first would not overlap it, but keeping the large pattern
# greedy is the cheap way to never have a small fuse shadow a big one),
# then the conv+bn bottleneck, then the epilogue/residual pairs
FUSION_PIPELINE = ("fuse_attention", "fuse_bottleneck",
                   "fuse_bias_act", "fuse_layer_norm")


def enabled_passes(disable=None):
    """The default pipeline minus ``disable`` (an iterable of names, or
    None to read ``FLAGS_graph_opt_disable`` — comma-separated)."""
    if disable is None:
        disable = flags.flag("graph_opt_disable")
    if isinstance(disable, str):
        disable = [p.strip() for p in disable.split(",") if p.strip()]
    disable = set(disable)
    # validated against the structural pipeline: the fusion tier has its
    # own knob (FLAGS_graph_opt_fuse_disable), and a name that would do
    # nothing here must say so
    unknown = disable - set(DEFAULT_PIPELINE)
    if unknown:
        raise KeyError(
            f"unknown graph-opt pass(es) {sorted(unknown)}; known: "
            f"{list(DEFAULT_PIPELINE)} (fusion passes are disabled via "
            f"FLAGS_graph_opt_fuse_disable)")
    return tuple(p for p in DEFAULT_PIPELINE if p not in disable)


def optimize_program(program, fetch_names=(), feed_names=(),
                     params=None, passes=None, disable=None,
                     program_key=None, record=True, clone=True):
    """Run the pass pipeline over a clone of `program` and return
    ``(optimized_program, report)``; the input program is never mutated
    (clone=False rewrites `program` itself, for callers that already
    cloned).

    params: optional {name: ndarray} of concrete parameter values —
    enables the value-based folds, which update the dict IN PLACE (pass
    a copy if the originals must survive).

    The report is the ``kind="pass_pipeline"`` record: per-pass
    before/after op counts and wall time, plus totals."""
    names = tuple(passes) if passes is not None \
        else enabled_passes(disable)
    unknown = set(names) - set(PASSES)
    if unknown:
        raise KeyError(f"unknown graph-opt pass(es) {sorted(unknown)}")
    t0 = time.perf_counter()
    # clone() carries _folded_constants; passes may add more
    opt = program.clone(for_test=program._is_test) if clone else program
    rw = ProgramRewriter(opt, fetch_names=fetch_names,
                         feed_names=feed_names, params=params)
    before = len(rw.ops)
    rows = []
    for name in names:
        stats = rw.timed(PASSES[name])
        stats["name"] = name
        rows.append(stats)
    report = {
        "kind": "pass_pipeline",
        "key": program_key or "prog%x:v%d" % (id(program),
                                              program._version),
        "before_ops": before,
        "after_ops": len(rw.ops),
        "ops_removed": before - len(rw.ops),
        "passes": rows,
        "total_wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
    }
    return opt, report


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
    (``matched``)."""
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


def fold_inference(program, params, fetch_names=(), program_key=None,
                   record=True, disable=None):
    """The Predictor's load-time path: the full pipeline, the value-based
    folds included, over an inference program and its parameter values
    ({name: ndarray}).  Returns ``(program, params, report)``; `params`
    is a new dict with the folded values (the originals untouched)."""
    params = dict(params)
    opt, report = optimize_program(
        program, fetch_names=fetch_names, params=params,
        program_key=program_key, record=record, disable=disable)
    # folded constants double as parameters on the interpret path
    for n, v in (getattr(opt, "_folded_constants", None) or {}).items():
        params.setdefault(n, v)
    return opt, params, report
