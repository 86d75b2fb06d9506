"""Diagnostic vocabulary of the static Program verifier.

Parity target: the reference's build-time validation layer — per-op
``InferShape`` / ``InferVarType`` (framework/operator.h OperatorWithKernel)
plus the enforce-style error decoration of op_call_stack.cc.  Every
diagnostic carries a STABLE code so tooling (bench rows, telemetry
reports, CI greps) can assert on classes of problems without string
matching:

=======  =========  ====================================================
code     severity   meaning
=======  =========  ====================================================
PT101    error      shape inference failure (incompatible shapes)
PT102    error      dtype mismatch (e.g. float ids into lookup_table)
PT103    error      use-before-def of a non-persistable variable
PT104    error      fetch target never produced by the program
PT105    error      unregistered op type (no TPU kernel)
PT106    error      stateful op's *Out slot doesn't alias its input
                    (ParamOut != Param: the update would be dropped)
PT107    error      data-parallel feed batch dim not divisible by mesh
PT108    error      backward-section loss undefined at section position
PT301    error      partition rule-miss on a trainable parameter
PT302    warning    replicated parameter above
                    FLAGS_replicated_param_bytes (shard the embedding)
PT303    warning    resharding on a forward (hot) edge — the implied
                    collective runs in fwd AND its mirrored backward
PT304    error      sharded dim not divisible by its mesh-axis size
PT305    error      conflicting sharding specs join at one op
PT306    error      sharded reduction's pending psum never lands
                    (a fetch would observe one shard's partial sum)
PT201    warning    dead op (outputs never read, fetched, or persisted)
PT202    warning    dead var (declared but never produced or read)
PT203    warning    write-after-write (value overwritten, never read)
PT204    warning    no shape rule for op type (outputs treated OPAQUE)
PT205    warning    backward-section loss is not a scalar (executor
                    sums it; usually wants mean/reduce first)
PT206    warning    parameter unreachable from its section's loss
                    (gradient will be identically zero)
PT207    warning    collective op in a program run without a dp mesh
PT208    warning    fetch of a persistable var the compiled step
                    donates (executor device-copies to stay sound)
PT209    warning    shape rule crashed (internal; outputs degraded to
                    OPAQUE — never a false error)
PT401    error      numerically fragile op (AMP black-list family:
                    softmax/exp/log/loss) computing in bf16/fp16
PT402    error      optimizer update whose param or accumulator chain
                    lost its fp32 master copy
PT403    warning    cast churn: redundant up/down cast pairs or a
                    value re-cast to the same dtype (with byte cost)
PT404    warning    overflow-prone accumulation: low-precision
                    reduction over FLAGS_numerics_reduce_elems elements
PT405    warning    fp16 training without loss scaling reaching the
                    anomaly guard's sample point
PT406    warning    fusion near-miss: a fuse pattern almost matched
                    but a named guard blocked it
PT407    warning    feed/fetch dtype drift vs the declared VarDesc
                    (forces an implicit hot-path cast)
=======  =========  ====================================================
"""

ERROR = "error"
WARNING = "warning"

# code -> (severity, one-line meaning) — the table README renders
CODES = {
    "PT101": (ERROR, "shape inference failure"),
    "PT102": (ERROR, "dtype mismatch"),
    "PT103": (ERROR, "use-before-def of non-persistable variable"),
    "PT104": (ERROR, "fetch target never produced"),
    "PT105": (ERROR, "unregistered op type"),
    "PT106": (ERROR, "stateful op output does not alias its input"),
    "PT107": (ERROR, "dp batch dim not divisible by mesh size"),
    "PT108": (ERROR, "backward-section loss undefined at section"),
    "PT301": (ERROR, "partition rule-miss on a trainable parameter"),
    "PT302": (WARNING, "replicated parameter above the byte threshold"),
    "PT303": (WARNING, "resharding on a forward (hot) edge"),
    "PT304": (ERROR, "sharded dim not divisible by mesh-axis size"),
    "PT305": (ERROR, "conflicting sharding specs join"),
    "PT306": (ERROR, "pending partial sum never resolved"),
    "PT201": (WARNING, "dead op"),
    "PT202": (WARNING, "dead variable"),
    "PT203": (WARNING, "write-after-write without a read"),
    "PT204": (WARNING, "no shape rule (outputs opaque)"),
    "PT205": (WARNING, "non-scalar backward-section loss"),
    "PT206": (WARNING, "parameter unreachable from loss"),
    "PT207": (WARNING, "collective op outside a dp mesh"),
    "PT208": (WARNING, "fetch of a donated persistable variable"),
    "PT209": (WARNING, "shape rule crashed (degraded to opaque)"),
    "PT401": (ERROR, "numerically fragile op in low-precision compute"),
    "PT402": (ERROR, "optimizer update lost its fp32 master copy"),
    "PT403": (WARNING, "cast churn (redundant up/down cast pairs)"),
    "PT404": (WARNING, "overflow-prone low-precision accumulation"),
    "PT405": (WARNING, "fp16 training without loss scaling"),
    "PT406": (WARNING, "fusion near-miss (blocked by a named guard)"),
    "PT407": (WARNING, "feed/fetch dtype drift vs declared VarDesc"),
}


class Diagnostic:
    """One finding: stable code + severity + the op's ProgramDesc
    identity and creation callsite (op_call_stack.cc parity — the
    provenance a tracer error would have lost)."""

    __slots__ = ("code", "message", "op_type", "op_index", "callsite",
                 "var")

    def __init__(self, code, message, op_type=None, op_index=None,
                 callsite=None, var=None):
        if code not in CODES:
            raise ValueError(f"unknown diagnostic code {code!r}")
        self.code = code
        self.message = message
        self.op_type = op_type
        self.op_index = op_index
        self.callsite = callsite
        self.var = var

    @property
    def severity(self):
        return CODES[self.code][0]

    def render(self):
        where = ""
        if self.op_type is not None:
            where = f" [op '{self.op_type}'"
            if self.op_index is not None:
                where += f" #{self.op_index}"
            where += "]"
        site = f" (created at {self.callsite})" if self.callsite else ""
        return f"{self.code} {self.severity}: {self.message}{where}{site}"

    def to_dict(self):
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "op_type": self.op_type,
            "op_index": self.op_index,
            "callsite": self.callsite,
            "var": self.var,
        }

    def __repr__(self):
        return f"Diagnostic({self.render()})"


class LintResult:
    """All diagnostics of one verifier run over one (program, version),
    with the count-by-code summary the telemetry/bench surfaces use."""

    def __init__(self, diagnostics=(), program_key=None, wall_ms=None):
        self.diagnostics = list(diagnostics)
        self.program_key = program_key
        self.wall_ms = wall_ms
        # the full ShardingAnalysis when partition rules were in play
        # (verifier pass 6); None otherwise
        self.sharding = None
        # the full NumericsAnalysis from verifier pass 7 (PT4xx);
        # None when the numerics pass did not run
        self.numerics = None

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self):
        return not self.errors

    def by_code(self):
        out = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    def render(self):
        if not self.diagnostics:
            return "program lint: clean"
        lines = [f"program lint: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines += ["  " + d.render() for d in self.diagnostics]
        return "\n".join(lines)

    def to_record(self):
        """The kind="lint" telemetry record (one JSONL line; the flight
        recorder and tools/telemetry_report.py read the same shape)."""
        rec = {
            "kind": "lint",
            "key": self.program_key,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "codes": self.by_code(),
        }
        if self.wall_ms is not None:
            rec["wall_ms"] = round(self.wall_ms, 3)
        if self.errors:
            rec["first_error"] = self.errors[0].render()
        # PT4xx provenance rides the SAME record (telemetry_report's
        # lint section breaks these out; a forked record kind would
        # make "newest per key wins" ambiguous between the two)
        if self.numerics is not None:
            guards = self.numerics.near_miss_guards()
            if guards:
                rec["near_miss_guards"] = guards
            if self.numerics.churn_bytes:
                rec["cast_churn_bytes"] = self.numerics.churn_bytes
        return rec

    def __repr__(self):
        return (f"LintResult(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")


class ProgramLintError(RuntimeError):
    """Raised by FLAGS_static_check=error BEFORE tracing: the failure
    the reference's InferShape would have produced at build time, with
    the op identity + callsite a mid-trace tracer error loses."""

    def __init__(self, result):
        self.result = result
        super().__init__(result.render())
