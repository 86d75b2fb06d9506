"""`fluid.distribute_lookup_table` import-path compatibility (port of
paddle_tpu/distribute_lookup_table.py).

Parity: python/paddle/fluid/distribute_lookup_table.py: helpers the
transpiler era used to locate the (single) distributed embedding
table in a program.  Works over the JSON-IR Program: a distributed
table is a lookup_table/embedding op with is_distributed=True.
"""

LOOKUP_TABLE_TYPE = "lookup_table"
_LOOKUP_OPS = ("lookup_table", "lookup_table_v2", "embedding")

__all__ = [
    "find_distributed_lookup_table",
    "find_distributed_lookup_table_inputs",
    "find_distributed_lookup_table_outputs",
]


def _distributed_lookup_ops(program, table_name=None):
    for op in program.global_block().ops:
        if op.type in _LOOKUP_OPS and op.attrs.get("is_distributed"):
            w = op.inputs.get("W")
            name = w[0] if isinstance(w, (list, tuple)) else w
            if table_name is None or name == table_name:
                yield op, name


def find_distributed_lookup_table(program):
    """Name of the distributed table, or None.  Reference constraint
    kept: at most ONE distributed table per program."""
    names = {name for _, name in _distributed_lookup_ops(program)}
    if len(names) > 1:
        raise ValueError(
            "only one distributed lookup table is supported, found %s"
            % sorted(names))
    return names.pop() if names else None


def find_distributed_lookup_table_inputs(program, table_name):
    inputs = []
    for op, _ in _distributed_lookup_ops(program, table_name):
        ids = op.inputs.get("Ids")
        inputs.extend(ids if isinstance(ids, (list, tuple)) else [ids])
    return inputs


def find_distributed_lookup_table_outputs(program, table_name):
    outputs = []
    for op, _ in _distributed_lookup_ops(program, table_name):
        out = op.outputs.get("Out")
        outputs.extend(out if isinstance(out, (list, tuple)) else [out])
    return outputs
