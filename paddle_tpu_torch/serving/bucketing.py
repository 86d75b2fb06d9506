"""Bucketed micro-batching over a Predictor / CompiledPredictor (port of
paddle_tpu/serving/bucketing.py).

Concurrent requests coalesce into a SMALL set of padded bucket shapes:

- buckets default to powers of two up to `max_batch` (1, 2, 4, 8...),
  so padding waste is < 2x and the shape set is O(log max_batch);
- every bucket is warmed at STARTUP (`prewarm`): the reference
  AOT-compiles each bucket; the port's `Predictor` is the eager
  interpreter, so `prewarm` runs each bucket once on zeros, which
  builds the kernels and settles cuBLAS's plans for that shape, and
  counts `serving.bucket_compile` per bucket;
- the per-bucket callable cache is keyed like the reference's — (program
  identity, program version, bucket, per-feed feature signature, fetch
  names) — so a mutated program or a changed feature shape never
  serves a stale entry;
- `export_aot` / `import_aot` write and load one `torch.export`
  artifact per bucket (``b<bucket>.pt2``, the `Predictor.export_compiled`
  route), the cold-start cache a later replica loads instead of warming.

Padding rows are zeros and are sliced off before results leave the
runtime.  A padded row equals the same row run through `Predictor.run`
at the same padded bucket bitwise (the same module on the same shape).
Against an unbatched run the rows agree to rounding only: cuBLAS picks
its algorithm by shape, so a row of an 8-row GEMM may round differently
from the same row alone (ROADMAP §3 keeps the card's number).

`dispatch` copies the outputs to the host inside the call, so a CUDA
error or a stall surfaces inside the runtime's watchdog/retry/breaker
envelope, charged to the batch that caused it, and the latency it
reports includes the device time.
"""

import contextlib
import io
import os

import numpy as np
import torch

from ..framework.executor import feed_tensor
from ..inference import _to_numpy

__all__ = ["default_buckets", "pick_bucket", "BucketDispatcher"]


def default_buckets(max_batch):
    """Powers of two up to max_batch, plus max_batch itself: the
    smallest shape set with bounded (<2x) padding waste."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return out


def pick_bucket(buckets, rows):
    """Smallest bucket that fits `rows` (buckets sorted ascending)."""
    for b in buckets:
        if rows <= b:
            return b
    raise ValueError(f"{rows} rows exceed the largest bucket "
                     f"{buckets[-1]}")


def _mon():
    from .. import monitor

    return monitor


def _device_scope(device):
    """The worker thread's current CUDA device is per thread: pin it to
    the predictor's card for the call."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class BucketDispatcher:
    """Shape the batching + per-bucket callable cache around one
    predictor.

    Works over either engine:
      - `Predictor`: one cached callable per bucket (its interpreter,
        or an imported `.pt2` artifact); the eager path exists for
        degraded mode.
      - `CompiledPredictor`: the exported artifact IS the single bucket
        (its exported batch dim); no eager path.
    """

    def __init__(self, predictor, buckets=None, max_batch=8,
                 label="serving"):
        self.predictor = predictor
        self.label = label
        self.device = getattr(predictor, "device", None)
        self._cache = {}          # full key -> callable(*feeds)
        if hasattr(predictor, "_exported"):       # CompiledPredictor
            self.buckets = [self._exported_batch_dim()]
            self.feed_names = list(predictor.get_input_names())
            self._exported_dtypes = dict(zip(
                self.feed_names, (dt for _shape, dt in
                                  predictor.in_avals)))
            self._specs = None
        else:                                     # Predictor
            self.buckets = sorted(set(
                buckets if buckets else default_buckets(max_batch)))
            self.feed_names = list(predictor.get_input_names())
            self._specs = predictor.feed_specs()
        self.max_rows = self.buckets[-1]

    # -- CompiledPredictor introspection --------------------------------
    def _exported_batch_dim(self):
        dims = {int(shape[0]) for shape, _dt in self.predictor.in_avals
                if shape}
        if len(dims) != 1:
            raise ValueError(
                f"CompiledPredictor artifact has no single batch dim "
                f"(leading dims {sorted(dims)}); serve it through "
                f"Predictor instead")
        return dims.pop()

    # -- feeds ----------------------------------------------------------
    def prepare(self, feed):
        """(prepared feed dict of tensors on the device, row count) for
        one request; raises on missing feeds, mismatched per-feed row
        counts, or a request larger than the biggest bucket (callers
        split those — admission control rejects them loudly instead)."""
        if hasattr(self.predictor, "prepare_feed"):
            prepared = self.predictor.prepare_feed(feed)
        else:
            prepared = {}
            for n in self.feed_names:
                if n not in feed:
                    raise KeyError(f"missing feed '{n}'")
                prepared[n] = feed_tensor(feed[n],
                                          self._exported_dtypes.get(n),
                                          self.device)
        rows = {n: (int(a.shape[0]) if a.ndim else 1)
                for n, a in prepared.items()}
        distinct = set(rows.values())
        if len(distinct) != 1:
            raise ValueError(f"feeds disagree on batch rows: {rows}")
        n_rows = distinct.pop()
        if n_rows < 1:
            raise ValueError("empty request (0 rows)")
        if n_rows > self.max_rows:
            raise ValueError(
                f"request of {n_rows} rows exceeds the largest serving "
                f"bucket {self.max_rows}; split it client-side or raise "
                f"max_batch")
        return prepared, n_rows

    def merge(self, prepared_list, bucket):
        """Concatenate prepared request feeds along the batch axis and
        zero-pad to `bucket` rows.  Returns (batched feed dict,
        [(start, stop) row slice per request])."""
        slices = []
        off = 0
        for p in prepared_list:
            rows = int(next(iter(p.values())).shape[0])
            slices.append((off, off + rows))
            off += rows
        if off > bucket:
            raise ValueError(f"{off} rows exceed bucket {bucket}")
        batched = {}
        for n in self.feed_names:
            parts = [p[n] for p in prepared_list]
            if off < bucket:
                parts.append(parts[0].new_zeros(
                    (bucket - off,) + tuple(parts[0].shape[1:])))
            batched[n] = parts[0] if len(parts) == 1 \
                else torch.cat(parts, dim=0)
        return batched, slices

    @staticmethod
    def split(outs, slices):
        """Per-request output lists from one batched result: request i
        gets [fetch[start_i:stop_i] for each fetch] — padding rows
        never leave the runtime."""
        return [[o[start:stop] for o in outs] for start, stop in slices]

    # -- per-bucket callable cache (keyed like the reference's) ---------
    def _feat_sig(self, batched):
        return tuple(
            (n, tuple(batched[n].shape[1:]), str(batched[n].dtype))
            for n in sorted(batched))

    def _key(self, bucket, feat_sig):
        p = self.predictor
        if hasattr(p, "_exported"):
            return (id(p._exported), 0, bucket, feat_sig, None)
        return (id(p._program), getattr(p._program, "_version", 0),
                bucket, feat_sig, tuple(p.get_output_names()))

    def _interpreter(self, *feeds):
        return self.predictor._outputs(dict(zip(self.feed_names, feeds)))

    def _run(self, fn, batched):
        with _device_scope(self.device), torch.no_grad():
            outs = fn(*(batched[n] for n in self.feed_names))
            # the host copy synchronizes: errors and stalls of this
            # batch surface here, inside the caller's envelope
            return [_to_numpy(o) for o in outs]

    def _compile(self, bucket, feat_sig):
        """Cache the interpreter for the bucket, counted as
        `serving.bucket_compile` like the reference's AOT compile (the
        caller runs it at the bucket shape: prewarm on zeros, which
        builds every kernel the program reaches and settles the library
        plans, or dispatch on the batch that missed)."""
        self._cache[self._key(bucket, feat_sig)] = self._interpreter
        mon = _mon()
        if mon.is_enabled():
            mon.counter("serving.bucket_compile").add(1)
        return self._interpreter

    def _zero_example(self, bucket):
        """A zeros feed dict at the bucket shape, or None when any
        trailing dim is dynamic (prewarm then waits for real traffic
        to reveal the feature shapes)."""
        if self._specs is None:
            return None
        example = {}
        for n in self.feed_names:
            feat, dtype = self._specs[n]
            if feat is None or any(d is None for d in feat):
                return None
            example[n] = torch.zeros((bucket,) + tuple(feat), dtype=dtype,
                                     device=self.device)
        return example

    def prewarm(self):
        """Warm every bucket at startup so traffic never pays a kernel
        build.  Returns the number of buckets warmed; 0 when shapes are
        dynamic or the engine is a CompiledPredictor."""
        if hasattr(self.predictor, "_exported"):
            return 0
        n = 0
        for bucket in self.buckets:
            example = self._zero_example(bucket)
            if example is None:
                return n
            if self._key(bucket, self._feat_sig(example)) in self._cache:
                continue           # already imported from the AOT cache
            self._run(self._interpreter, example)
            self._compile(bucket, self._feat_sig(example))
            n += 1
        return n

    # -- AOT artifact cache ---------------------------------------------
    def export_aot(self, dirname, platforms=None):
        """Write one `torch.export` artifact per bucket (``b<bucket>.pt2``)
        into `dirname` — the cold-start cache a later replica imports
        instead of warming.  The kernels reached are custom ops in the
        exported graph (`kernels.backend.traced_kernels`), so the
        artifact launches them too.  `platforms` is the one device type
        the artifact is for and must be the predictor's.  Returns the
        number of artifacts written (0 for a CompiledPredictor — it
        already IS the artifact — or when shapes are dynamic)."""
        if hasattr(self.predictor, "_exported"):
            return 0
        if platforms is not None:
            plats = [platforms] if isinstance(platforms, str) \
                else list(platforms)
            if len(plats) != 1 or \
                    torch.device(plats[0]).type != self.device.type:
                raise ValueError(
                    f"export_aot: platforms {plats} must be the one "
                    f"device type of the predictor ({self.device})")
        from ..kernels import backend

        os.makedirs(dirname, exist_ok=True)
        n = 0
        for bucket in self.buckets:
            example = self._zero_example(bucket)
            if example is None:
                return n
            with backend.traced_kernels(), torch.no_grad():
                exported = torch.export.export(
                    self.predictor._module,
                    tuple(example[f] for f in self.feed_names))
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            path = os.path.join(dirname, f"b{bucket}.pt2")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)
            n += 1
        return n

    def import_aot(self, dirname):
        """Load per-bucket artifacts into the callable cache WITHOUT
        warming — zero `serving.bucket_compile` events, which is the
        whole point: a cold replica reaches first byte on cache hits
        alone.  Each artifact lands under the same cache key `_compile`
        would have used, so a version/shape mismatch simply misses and
        falls through to a (counted) warm-up instead of serving a stale
        entry.  Returns the number of buckets imported."""
        if hasattr(self.predictor, "_exported"):
            return 0
        # the artifacts call the kernels' custom ops: register them
        from ..kernels import flash_attention, layer_norm  # noqa: F401

        n = 0
        for bucket in self.buckets:
            path = os.path.join(dirname, f"b{bucket}.pt2")
            if not os.path.isfile(path):
                continue
            example = self._zero_example(bucket)
            if example is None:
                return n
            module = torch.export.load(path).module()
            key = self._key(bucket, self._feat_sig(example))
            self._cache[key] = module
            n += 1
        mon = _mon()
        if n and mon.is_enabled():
            mon.counter("serving.aot_import").add(n)
        return n

    def dispatch(self, batched, bucket):
        """Run one padded bucket batch through the cached callable for
        (bucket, feature signature) — warming on a miss (a shape prewarm
        could not predict) — and return the fetch list as host numpy
        arrays: the copy synchronizes, so a dispatch error surfaces
        HERE, inside the breaker/retry/watchdog envelope, not at some
        caller's later sync point."""
        if hasattr(self.predictor, "_exported"):
            return self._run(self.predictor._fn, batched)
        key = self._key(bucket, self._feat_sig(batched))
        fn = self._cache.get(key)
        if fn is None:
            fn = self._compile(bucket, self._feat_sig(batched))
        return self._run(fn, batched)

    # -- degraded paths -------------------------------------------------
    @property
    def eager_available(self):
        return hasattr(self.predictor, "run_eager")

    def dispatch_eager(self, prepared):
        """One UNBATCHED request through the op-by-op interpreter — the
        breaker-open fallback, on the same device as the batched path."""
        with _device_scope(self.device):
            return [np.asarray(o) for o in
                    self.predictor.run_eager(prepared)]
