"""`fluid.data_feed_desc` import-path compatibility.

Parity: python/paddle/fluid/data_feed_desc.py (DataFeedDesc :21):
describes the MultiSlot input format.  The reference parses a
data_feed.proto text message; this implementation parses the same
prototxt surface with a small recursive reader (no protobuf
runtime), exposing the documented mutators and a `desc()` that
re-serializes, and feeds the same slot schema the native MultiSlot
reader (csrc/data_feed.cpp) consumes.
"""

__all__ = ["DataFeedDesc"]


def _parse_prototxt(text):
    """Minimal prototxt reader for the data_feed.proto shape:
    scalar fields (`name: "x"`, `batch_size: 2`) and repeated/nested
    messages (`multi_slot_desc { slots { ... } }`)."""
    import re
    tokens = re.findall(r'[{}]|[A-Za-z_]\w*\s*:\s*(?:"[^"]*"|[^\s}]+)|'
                        r'[A-Za-z_]\w*(?=\s*\{)', text)
    pos = 0

    def parse_block():
        nonlocal pos
        msg = {}
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "}":
                pos += 1
                return msg
            pos += 1
            if ":" in tok:
                key, _, raw = tok.partition(":")
                key, raw = key.strip(), raw.strip()
                if raw.startswith('"'):
                    val = raw[1:-1]
                elif raw in ("true", "false"):
                    val = raw == "true"
                else:
                    try:
                        val = int(raw)
                    except ValueError:
                        val = float(raw)
                msg[key] = val
            else:
                assert tokens[pos] == "{", "expected { after %s" % tok
                pos += 1
                sub = parse_block()
                if tok == "slots":
                    msg.setdefault(tok, []).append(sub)
                else:
                    msg[tok] = sub
        return msg

    return parse_block()


def _emit(msg, indent=0):
    pad = "  " * indent
    out = []
    for key, val in msg.items():
        if isinstance(val, dict):
            out.append("%s%s {" % (pad, key))
            out.append(_emit(val, indent + 1))
            out.append("%s}" % pad)
        elif isinstance(val, list):
            for item in val:
                out.append("%s%s {" % (pad, key))
                out.append(_emit(item, indent + 1))
                out.append("%s}" % pad)
        elif isinstance(val, bool):
            out.append("%s%s: %s" % (pad, key, "true" if val else "false"))
        elif isinstance(val, str):
            out.append('%s%s: "%s"' % (pad, key, val))
        else:
            out.append("%s%s: %s" % (pad, key, val))
    return "\n".join(out)


class DataFeedDesc:
    def __init__(self, proto_file):
        with open(proto_file) as f:
            self.proto_desc = _parse_prototxt(f.read())
        self._name_to_idx = {}
        if self.proto_desc.get("name") == "MultiSlotDataFeed":
            slots = self.proto_desc.get("multi_slot_desc", {}) \
                .get("slots", [])
            self._name_to_idx = {s["name"]: i for i, s in enumerate(slots)}

    def _slots(self):
        if not self._name_to_idx:
            raise ValueError("only MultiSlotDataFeed descs have slots")
        return self.proto_desc["multi_slot_desc"]["slots"]

    def set_batch_size(self, batch_size):
        self.proto_desc["batch_size"] = batch_size

    def set_dense_slots(self, dense_slots_name):
        slots = self._slots()
        for name in dense_slots_name:
            slots[self._name_to_idx[name]]["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        slots = self._slots()
        for name in use_slots_name:
            slots[self._name_to_idx[name]]["is_used"] = True

    def desc(self):
        return _emit(self.proto_desc) + "\n"
