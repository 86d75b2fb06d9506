"""JSONL emission for telemetry records (port of
paddle_tpu/monitor/jsonl_writer.py).

One JSON object per line, append-only — the format every monitoring
pipeline ingests without a schema negotiation.  The writer is the sink
MetricsSession emits step records into; `read_jsonl` is the matching
parser.

Fleet additions:

- **Rank tagging** — every emitted line is stamped with this process's
  fleet identity (``host`` / ``process_index``, `rank.py`), so N rank
  streams written into one shared directory stay attributable after
  the merge.  The in-process record dicts are never mutated — the stamp
  exists only on the serialized line.
- **Size-capped rotation** — when the active segment passes
  ``FLAGS_telemetry_max_mb`` it rotates to ``<path>.1`` (older segments
  shift up, the oldest beyond ``FLAGS_telemetry_keep`` is deleted), so
  an always-on week-long run cannot fill a disk.  ``read_jsonl`` reads
  rotated segments transparently, oldest first.
"""

import json
import os
import threading

__all__ = ["JsonlWriter", "read_jsonl"]


class JsonlWriter:
    """Append dict records to a .jsonl file, one flushed line each.

    Opened lazily on first emit (so enabling telemetry without steps
    never creates an empty file) and safe to emit from the producer
    thread and the main thread concurrently.  `max_bytes`/`keep`
    default to the FLAGS_telemetry_max_mb / FLAGS_telemetry_keep
    rotation policy (max_bytes=0 never rotates); `rank_tag=False`
    writes unstamped lines, for callers that stamp or don't need the
    fleet identity themselves."""

    def __init__(self, path, max_bytes=None, keep=None, rank_tag=True):
        self.path = path
        self._fh = None
        self._closed = False
        self._lock = threading.Lock()
        if max_bytes is None or keep is None:
            from .. import flags

            if max_bytes is None:
                max_bytes = int(flags.flag("telemetry_max_mb")) << 20
            if keep is None:
                keep = int(flags.flag("telemetry_keep"))
        self._max_bytes = int(max_bytes)
        self._keep = max(1, int(keep))
        self._bytes = 0
        self._rank_tag = rank_tag
        self._shift_done = False   # segments shifted, final rename owed

    def emit(self, record):
        if self._rank_tag:
            # stamp the LINE, not the caller's dict: session records
            # are shared with the in-process ring and must stay clean
            from .rank import rank_tag

            record = {**rank_tag(), **record}
        line = json.dumps(record, sort_keys=True, default=_json_default)
        with self._lock:
            if self._closed:
                # a producer thread racing monitor.disable() must not
                # reopen the just-closed file (leaked handle + a write
                # after detach); the boundary record is dropped instead
                return
            if self._fh is None:
                self._fh = open(self.path, "a")
                try:
                    self._bytes = os.fstat(self._fh.fileno()).st_size
                except OSError:
                    self._bytes = 0
            self._fh.write(line + "\n")
            self._fh.flush()
            self._bytes += len(line) + 1
            if self._max_bytes and self._bytes >= self._max_bytes:
                self._rotate_locked()

    def _rotate_locked(self):
        """Active segment -> <path>.1, shifting older segments up and
        dropping the one past the keep count.  Failures (a reader
        holding a segment on an odd filesystem) leave the writer
        appending to the oversized active file — rotation is a bound,
        never a crash."""
        # detach BEFORE closing: close() can itself raise (the final
        # flush on a full disk) yet still marks the file closed — a
        # stale handle here would turn every later emit into a
        # ValueError instead of a reopen-and-append
        fh, self._fh = self._fh, None
        try:
            fh.close()
            # the shift runs at most once per owed rotation: if the
            # final active-file rename below keeps failing, re-running
            # the delete-and-shift on every retry would churn away ALL
            # retained segments while the active file never rotates
            if not self._shift_done:
                oldest = f"{self.path}.{self._keep}"
                if os.path.exists(oldest):
                    os.remove(oldest)
                for i in range(self._keep - 1, 0, -1):
                    src = f"{self.path}.{i}"
                    if os.path.exists(src):
                        os.replace(src, f"{self.path}.{i + 1}")
                self._shift_done = True
            os.replace(self.path, f"{self.path}.1")
            self._shift_done = False
        except OSError:
            pass
        self._bytes = 0

    def close(self):
        """Close and RETIRE the writer: later emits are dropped, never
        reopened — close is the end of this writer's life."""
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _json_default(o):
    # numpy scalars (step counters fed from device fetches) serialize as
    # their python value; anything else degrades to repr rather than
    # killing the training loop that emitted it
    try:
        return o.item()
    except AttributeError:
        return repr(o)


def _segments(path):
    """The stream's on-disk segments, oldest first: rotated
    ``path.K .. path.1`` then the active ``path``.  Scans the directory
    rather than probing ``.1, .2, ...`` in sequence — a gap (a rotation
    interrupted mid-shift) must not silently hide the older retained
    segments that are still on disk."""
    d, base = os.path.split(path)
    prefix = base + "."
    idxs = []
    try:
        for name in os.listdir(d or "."):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                idxs.append(int(name[len(prefix):]))
    except OSError:
        pass
    segs = [f"{path}.{i}" for i in sorted(idxs, reverse=True)]
    if os.path.exists(path) or not segs:
        segs.append(path)
    return segs


def read_jsonl(path):
    """Parse a telemetry JSONL stream back into a list of dicts,
    skipping blank lines.  Rotated segments (``path.1``...) are read
    transparently, oldest first, so a report over a capped stream sees
    the whole retained window.  A malformed line raises ValueError
    naming the file and line number — a truncated tail from a killed
    run should be loud, not a silently shorter list."""
    out = []
    for seg in _segments(path):
        with open(seg) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{seg}:{i}: malformed JSONL record: {e}") from e
    return out
