"""Standalone static Program linter (port of tools/program_lint.py, the
paddle_tpu_torch.analysis CLI).

Lints serialized programs (Program.to_json files) or the bundled
static model zoo WITHOUT running them or touching a device — the
ProgramDesc-level pre-flight the reference ran as per-op InferShape at
build time.  Diagnostics carry stable PT codes, the op type/index, and
the op's creation callsite; see paddle_tpu_torch/analysis/diagnostics.py
for the table.  Its text, its --json records and its exit codes are the
reference CLI's for the same program:

- PT1xx  errors   (shape/dtype, def-use, aliasing, distributed)
- PT2xx  warnings (dead code, opaque rules, donation fetches)
- PT3xx  sharding lints (with --sharding-rules): PT301 rule-miss,
  PT302 replicated giant param, PT303 hot-edge reshard, PT304
  divisibility, PT305 conflicting join, PT306 unresolved pending psum
  — plus the implied-collective cost table and the static per-shard
  peak-memory estimate in the --json records.
- PT4xx  numerics lints (always on; --amp/--fuse make them bite):
  PT401 fragile op in low precision, PT402 broken fp32 master chain,
  PT403 cast churn, PT404 overflow-prone low-precision accumulation,
  PT405 fp16 without loss scaling, PT406 fusion near-miss with the
  blocking guard named, PT407 feed/fetch dtype drift.

Usage (from the repository root):
  python -m paddle_tpu_torch.tools.program_lint <program.json>
      [--fetch a,b] [--dp N] [--sharding-rules rules.json] [--amp]
      [--fuse]
  python -m paddle_tpu_torch.tools.program_lint --model lenet
      [--sharding-rules default] [--lower]
  python -m paddle_tpu_torch.tools.program_lint --all-models
      [--sharding-rules default]
  python -m paddle_tpu_torch.tools.program_lint --all-models --amp
      --fuse --json

`--sharding-rules FILE` loads a partition-rule document ({"mesh":
{axis: size}, "rules": [[regex, [axis|null, ...]], ...], "data_axis":
"dp"}); the special value `default` uses each bundled model's own
default rule set (only with --model/--all-models).

`--amp` / `--fuse` lint the SAME substitute the executor dispatches
under FLAGS_amp / FLAGS_graph_opt_fuse: the AMP rewrite and/or the
fusion tier are applied (canonical order: AMP -> fusion) to each TRAIN
program before linting, so the PT4xx findings describe the casts and
fused kernels the Executor actually runs — the pristine source has no
casts to analyze.  Startup/inference programs pass through
untouched, exactly as the executor's train-tier gate does.

Exit-code contract (CI gates on it):
  0  clean — no PT1xx, no PT3xx and no PT4xx ERRORS anywhere
     (warnings allowed)
  1  at least one error-severity diagnostic
  2  usage / unreadable input

`--json` emits one machine-readable record per linted program (the
same shape tools/program_opt.py --json uses: a JSON array on stdout),
each carrying counts by code, every diagnostic's full detail, and —
when sharding rules are in play — the rule-match report, the implied
collective table, and the static memory estimate.
"""
import argparse
import json
import os
import sys


def _lint_one(label, program, fetch_names, dp_ndev, rules,
              feed_shapes=None, verbose=True):
    from paddle_tpu_torch import analysis

    # feed_shapes (zoo smoke batches) flow INTO the one verifier run:
    # shape-dependent PT3xx findings count toward the exit code and
    # the cost/memory records are byte-exact — no second analysis
    result = analysis.check_program(program, fetch_names=fetch_names,
                                    dp_ndev=dp_ndev, program_key=label,
                                    sharding=rules,
                                    feed_shapes=feed_shapes)
    if verbose:
        ops = sum(len(b.ops) for b in program.blocks)
        print(f"{label}: {ops} ops, {len(result.errors)} error(s), "
              f"{len(result.warnings)} warning(s)"
              f"  [{result.wall_ms:.1f} ms]")
        for d in result.diagnostics:
            print("  " + d.render())
        if result.sharding is not None:
            for line in result.sharding.render().splitlines():
                print("  " + line)
            for um in result.sharding.report["unmatched_rules"]:
                print(f"  rule {um['pattern']!r} matched no vars"
                      f"{um['suggestion']}")
    return result


def _train_substitute(program, fetch_names, do_amp, do_fuse):
    """The executor's train-tier substitute for `program` — the SAME
    resolver Executor.run dispatches through (_resolve_train_optimized,
    canonical order AMP rewrite -> fusion), behind the same gate: only
    TRAIN programs (backward sections, not a test clone) are rewritten;
    startup/inference programs lint as-is."""
    if not (do_amp or do_fuse) or program._is_test \
            or not program.backward_sections:
        return program
    from paddle_tpu_torch.framework.executor import Executor

    return Executor._resolve_train_optimized(
        program, list(fetch_names or ()),
        do_amp and not program.amp_enabled, do_fuse)


def _record(result):
    rec = result.to_record()
    rec["diagnostics"] = [d.to_dict() for d in result.diagnostics]
    if result.sharding is not None:
        rec["sharding"] = result.sharding.to_record()
        rec["memory"] = result.sharding.memory
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="program_lint.py",
        description=__doc__.splitlines()[0],
        epilog="exit status: 0 = no PT1xx/PT3xx/PT4xx errors, 1 = "
               "errors found, 2 = usage error")
    ap.add_argument("program", nargs="?",
                    help="Program.to_json file to lint")
    ap.add_argument("--model", help="lint one bundled static model "
                    "(mlp|lenet|resnet|bert|gpt|seq2seq|wide_deep|"
                    "word2vec)")
    ap.add_argument("--all-models", action="store_true",
                    help="lint every bundled static model (main + "
                    "startup programs)")
    ap.add_argument("--fetch", default=None,
                    help="comma-separated fetch names (enables the "
                    "fetch-dependent lints)")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel mesh size for the distributed "
                    "lints")
    ap.add_argument("--sharding-rules", default=None, metavar="FILE",
                    help="partition-rule JSON file enabling the PT3xx "
                    "sharding lints; 'default' uses each bundled "
                    "model's own default rule set")
    ap.add_argument("--lower", action="store_true",
                    help="with --sharding-rules: print the concrete "
                    "lowering plan (per-var placement, "
                    "activation pins, model collective table, static "
                    "per-shard memory) the GSPMD runtime tier would "
                    "execute — still fully static, nothing runs")
    ap.add_argument("--amp", action="store_true",
                    help="AMP-rewrite each train program (FLAGS_amp "
                    "parity) before linting, so the PT4xx numerics "
                    "lints see the casts the executor runs")
    ap.add_argument("--fuse", action="store_true",
                    help="run the fusion tier (FLAGS_graph_opt_fuse "
                    "parity) before linting — PT406 then explains "
                    "near-miss patterns with the blocking guard")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON records instead "
                    "of text (parity with tools/program_opt.py)")
    args = ap.parse_args(argv)

    file_rules = None
    if args.sharding_rules and args.sharding_rules != "default":
        from paddle_tpu_torch.analysis import sharding as _sh

        try:
            file_rules = _sh.load_rules_file(args.sharding_rules)
        except Exception as e:
            print(f"cannot load rules {args.sharding_rules}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2

    targets = []
    if args.all_models or args.model:
        from paddle_tpu_torch.models import static_zoo

        names = (sorted(static_zoo.BUILDERS) if args.all_models
                 else [args.model])
        for name in names:
            try:
                m = static_zoo.build(name)
            except KeyError as e:
                print(e, file=sys.stderr)
                return 2
            rules = file_rules
            feed_shapes = None
            if args.sharding_rules == "default":
                rules = m.partition_rules()
            if rules is not None:
                feed_shapes = m.smoke_feed_shapes()
            targets.append((f"{name}/main", m.main, m.fetches, rules,
                            feed_shapes))
            targets.append((f"{name}/startup", m.startup, [], None,
                            None))
    elif args.program:
        if args.sharding_rules == "default":
            print("--sharding-rules default needs --model/--all-models"
                  " (serialized programs carry no bundled rule set)",
                  file=sys.stderr)
            return 2
        from paddle_tpu_torch.framework.program import Program

        try:
            with open(args.program) as f:
                prog = Program.from_json(f.read())
        except Exception as e:
            print(f"cannot load {args.program}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2
        fetches = (args.fetch.split(",") if args.fetch else None)
        targets.append((os.path.basename(args.program), prog, fetches,
                        file_rules, None))
    else:
        ap.print_help()
        return 2

    if args.lower and not (file_rules or args.sharding_rules):
        print("--lower needs --sharding-rules (the lowering plan IS "
              "the rule set's placement)", file=sys.stderr)
        return 2

    any_errors = False
    records = []
    for label, prog, fetches, rules, feed_shapes in targets:
        sub = _train_substitute(prog, fetches, args.amp, args.fuse)
        result = _lint_one(label, sub, fetches, args.dp, rules,
                           feed_shapes=feed_shapes,
                           verbose=not args.json)
        rec = _record(result)
        if sub is not prog:
            rec["train_tier"] = {"amp": bool(args.amp),
                                 "fuse": bool(args.fuse)}
        if args.lower and rules is not None:
            from paddle_tpu_torch.analysis import sharding as _sh

            plan = _sh.lower(
                sub, rules, fetch_names=fetches,
                feed_names=sorted(feed_shapes or ()),
                feed_shapes=feed_shapes)
            if args.json:
                rec["lower"] = plan.to_record()
            else:
                print(f"{label}: lowering plan")
                for line in plan.render().splitlines():
                    print("  " + line)
        records.append(rec)
        any_errors = any_errors or not result.ok
    if args.json:
        print(json.dumps(records, indent=1))
    return 1 if any_errors else 0


if __name__ == "__main__":
    sys.exit(main())
