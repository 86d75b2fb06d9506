"""MultiSlot data generators.

Parity: python/paddle/fluid/incubate/data_generator/__init__.py —
DataGenerator (:21, generate_sample/generate_batch overridables,
run_from_stdin/run_from_memory runners), MultiSlotDataGenerator (:281)
and MultiSlotStringDataGenerator.  Emits the exact "<n> v1 ... vn"
per-slot text format the native MultiSlot feed parses
(csrc/data_feed.cpp), so 1.x ETL scripts produce files
QueueDataset/InMemoryDataset read unchanged.
"""

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- overridables ---------------------------------------------------
    def generate_sample(self, line):
        """Return a zero-arg iterator over parsed samples for one input
        line (line is None under run_from_memory)."""
        raise NotImplementedError(
            "please rewrite this function to return a generator of "
            "[(name, [value, ...]), ...] samples")

    def generate_batch(self, samples):
        """Optional batch-level hook; default passes samples through."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- runners --------------------------------------------------------
    def _flush(self, batch_samples, out):
        for sample in self.generate_batch(batch_samples)():
            out.write(self._gen_str(sample))

    def _drive(self, line_source, out):
        batch = []
        for line in line_source:
            for parsed in self.generate_sample(line)():
                if parsed is None:
                    continue
                batch.append(parsed)
                if len(batch) == self.batch_size_:
                    self._flush(batch, out)
                    batch = []
        if batch:
            self._flush(batch, out)

    def run_from_stdin(self, out=None):
        self._drive(sys.stdin, out or sys.stdout)

    def run_from_memory(self, out=None):
        self._drive([None], out or sys.stdout)

    def _gen_str(self, line):
        raise NotImplementedError(
            "please inherit MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator to generate string output")


class MultiSlotStringDataGenerator(DataGenerator):
    def _gen_str(self, line):
        """[(name, [str, ...]), ...] -> '<n> v1 .. vn <m> u1 .. um\\n'"""
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample must be list or tuple; "
                "e.g. [('words', ['1926', '08']), ('label', ['1'])]")
        parts = []
        for name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(MultiSlotStringDataGenerator):
    def _gen_str(self, line):
        """Numeric form: also tracks per-slot dtype like the reference's
        proto_info (float promotes uint64)."""
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample must be list or tuple")
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                dtype = ("float" if any(isinstance(e, float)
                                        for e in elements) else "uint64")
                self._proto_info.append((name, dtype))
        else:
            if len(line) != len(self._proto_info):
                raise ValueError(
                    f"the complete field set changed: expected "
                    f"{len(self._proto_info)} slots, got {len(line)}")
            for i, (name, elements) in enumerate(line):
                if name != self._proto_info[i][0]:
                    # reference :360 — reordered/renamed slots would
                    # silently column-swap the MultiSlot text
                    raise ValueError(
                        f"the field name of two given line are not "
                        f"match: require<{self._proto_info[i][0]}>, "
                        f"get<{name}>")
                if (self._proto_info[i][1] == "uint64"
                        and any(isinstance(e, float) for e in elements)):
                    self._proto_info[i] = (name, "float")
        return super()._gen_str(line)
