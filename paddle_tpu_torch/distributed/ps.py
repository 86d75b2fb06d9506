"""The parameter server's data plane (port of paddle_tpu/distributed/ps.py).

The reference's PS stack (operators/distributed/: RPCClient/RPCServer,
the Communicator modes, parameter_{send,recv,prefetch}.cc; the pslib
DownpourWorker pull -> compute -> push loop, framework/device_worker.h:203)
as the JAX package reshapes it:

- giant embedding tables live on the host in native C++ shards
  (csrc/ps_shard.cpp, built by the port's `native`), the optimizer
  (sgd or adagrad) folded into push; the device step only sees the dense
  [batch, dim] rows, the split Downpour uses (pull_sparse -> dense ops ->
  push_sparse).  Pulled rows come back as torch tensors on the table's
  device (None: the card), pushes take torch or numpy grads;
- `Communicator` has the reference's send modes (communicator.h:176):
  SYNC pushes inline, ASYNC / HALF_ASYNC batch pushes on a background
  thread, GEO accumulates locally and ships every k steps;
- `PSServer` / `PSClient` are the service over TCP, with the reference's
  length-prefixed binary wire format byte for byte (a frame of one
  package decodes in the other), which decodes only to data: no pickle,
  no object dtypes; `ShardedPSClient` routes ids over several servers.
"""

import queue
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import torch

__all__ = ["SparseEmbedding", "Communicator", "PSServer", "PSClient",
           "HeartBeatMonitor", "ShardedPSClient"]


def _host(x, dtype=None):
    """A numpy array of `x` (a torch tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _rows(a, device):
    """Pulled rows (float32 numpy) as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _scramble(ids):
    # same splitmix-style mix as the native shard so routing spreads
    # sequential feature ids uniformly
    x = ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return (x >> np.uint64(32)).astype(np.int64)


class _PyShard:
    """Pure-python fallback with the NativeShard interface."""

    def __init__(self, dim, init_range=0.05, seed=0, optimizer="adagrad",
                 lr=0.05, adagrad_eps=1e-6):
        self.dim = dim
        self.init_range = init_range
        self.seed = seed
        self.opt = optimizer
        self.lr = lr
        self.eps = adagrad_eps
        self.rows = {}
        self.accs = {}

    def _row(self, i):
        r = self.rows.get(i)
        if r is None:
            rng = np.random.default_rng(self.seed ^ (i & 0x7FFFFFFF))
            r = rng.uniform(-self.init_range, self.init_range,
                            self.dim).astype(np.float32)
            self.rows[i] = r
            if self.opt == "adagrad":
                self.accs[i] = np.zeros(self.dim, np.float32)
        return r

    def set_lr(self, lr):
        self.lr = lr

    def pull(self, ids):
        return np.stack([self._row(int(i)) for i in ids]) if len(ids) \
            else np.zeros((0, self.dim), np.float32)

    def push(self, ids, grads):
        for i, g in zip(ids, np.asarray(grads, np.float32)):
            i = int(i)
            r = self._row(i)
            if self.opt == "adagrad":
                acc = self.accs[i]
                acc += g * g
                r -= self.lr * g / (np.sqrt(acc) + self.eps)
            else:
                r -= self.lr * g

    def assign(self, ids, vals):
        for i, v in zip(ids, np.asarray(vals, np.float32)):
            self._row(int(i))[:] = v

    def __len__(self):
        return len(self.rows)

    def export(self):
        ids = np.fromiter(self.rows.keys(), dtype=np.int64,
                          count=len(self.rows))
        vals = (np.stack([self.rows[int(i)] for i in ids])
                if len(ids) else np.zeros((0, self.dim), np.float32))
        return ids, vals

    @property
    def row_width(self):
        return 2 * self.dim if self.opt == "adagrad" else self.dim

    def export_full(self):
        ids, vals = self.export()
        if self.opt != "adagrad":
            return ids, vals
        accs = (np.stack([self.accs[int(i)] for i in ids])
                if len(ids) else np.zeros((0, self.dim), np.float32))
        return ids, np.concatenate([vals, accs], axis=1)

    def assign_full(self, ids, vals):
        vals = np.asarray(vals, np.float32)
        for i, v in zip(ids, vals):
            i = int(i)
            self._row(i)[:] = v[:self.dim]
            if self.opt == "adagrad" and vals.shape[1] == 2 * self.dim:
                self.accs[i][:] = v[self.dim:]


def _make_shard(dim, **kw):
    from .. import native

    if native.available():
        return native.NativeShard(dim, **kw)
    return _PyShard(dim, **kw)


class SparseEmbedding:
    """N-way sharded host-resident embedding table.

    Parity surface: distributed_lookup_table_op + parameter_prefetch.cc
    (slice ids by shard, fetch, re-gather in input order).  `pull`
    returns a tensor on `device` (None: the card).
    """

    def __init__(self, dim, num_shards=4, optimizer="adagrad", lr=0.05,
                 init_range=0.05, seed=0, clients=None, device=None):
        from ..core.place import resolve_device

        self.dim = dim
        self.device = resolve_device(device)
        if clients is not None:          # remote mode: one client per shard
            self.shards = clients
        else:
            self.shards = [
                _make_shard(dim, init_range=init_range, seed=seed + i,
                            optimizer=optimizer, lr=lr)
                for i in range(num_shards)
            ]
        self.n = len(self.shards)

    def _route(self, ids):
        flat = np.ascontiguousarray(ids, dtype=np.int64).ravel()
        shard_of = _scramble(flat) % self.n
        return flat, shard_of

    def pull(self, ids):
        """ids: int array or tensor, any shape -> [*shape, dim] float32
        tensor on the table's device."""
        ids = _host(ids)
        flat, shard_of = self._route(ids)
        out = np.empty((flat.size, self.dim), np.float32)
        for s in range(self.n):
            m = shard_of == s
            if m.any():
                out[m] = self.shards[s].pull(flat[m])
        return _rows(out.reshape(*ids.shape, self.dim), self.device)

    def push(self, ids, grads):
        ids = _host(ids)
        flat, shard_of = self._route(ids)
        grads = np.ascontiguousarray(_host(grads, np.float32)).reshape(
            flat.size, self.dim)
        for s in range(self.n):
            m = shard_of == s
            if m.any():
                self.shards[s].push(flat[m], grads[m])

    def set_lr(self, lr):
        for s in self.shards:
            s.set_lr(lr)

    def __len__(self):
        return sum(len(s) for s in self.shards)

    def state_dict(self):
        """Full rows INCLUDING optimizer accumulators (adagrad), so a
        resumed run continues the uninterrupted trajectory — pserver
        table snapshots carry optimizer state too."""
        ids, vals = [], []
        full = all(hasattr(s, "export_full") for s in self.shards)
        for s in self.shards:
            i, v = (s.export_full() if full else s.export())
            ids.append(i)
            vals.append(v)
        width = vals[0].shape[1] if vals and len(vals[0]) else self.dim
        return {"ids": np.concatenate(ids) if ids else np.zeros(0, np.int64),
                "values": np.concatenate(vals) if vals
                else np.zeros((0, width), np.float32)}

    def load_state_dict(self, state):
        ids = np.asarray(state["ids"], np.int64)
        vals = np.asarray(state["values"], np.float32)
        flat, shard_of = self._route(ids)
        for s in range(self.n):
            m = shard_of == s
            if not m.any():
                continue
            shard = self.shards[s]
            if (vals.shape[1] > self.dim
                    and getattr(shard, "row_width", self.dim)
                    == vals.shape[1]):
                shard.assign_full(flat[m], vals[m])
            else:
                shard.assign(flat[m], vals[m][:, :self.dim])


class Communicator:
    """Batched gradient push with the reference's mode taxonomy
    (communicator.h:176 AsyncCommunicator/HalfAsync/Sync/GeoSgd).

    sync: push() forwards immediately.
    async/half_async: pushes queue to a background thread; half_async's
      barrier() drains the queue (the reference's batch-barrier).
    geo: local delta accumulation, shipped every `geo_steps` steps
      (GeoSgdCommunicator delta-sync).
    """

    def __init__(self, table, mode="async", geo_steps=10, max_merge=20):
        assert mode in ("sync", "async", "half_async", "geo")
        self.table = table
        self.mode = mode
        self.geo_steps = geo_steps
        self.max_merge = max_merge
        self._q = queue.Queue()
        self._stop = threading.Event()
        self._thread = None
        self._error = None
        self._geo_acc = {}
        self._step = 0
        if mode in ("async", "half_async"):
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                ids, grads = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            # merge a burst of pending pushes into one table update
            batch = [(ids, grads)]
            for _ in range(self.max_merge):
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                all_ids = np.concatenate([b[0] for b in batch])
                all_grads = np.concatenate([b[1] for b in batch])
                self.table.push(all_ids, all_grads)
            except Exception as e:  # surface at the next push/barrier;
                self._error = e     # task_done must still run or join()
                self._stop.set()    # deadlocks
            finally:
                for _ in batch:
                    self._q.task_done()

    def _check_error(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("communicator background push failed") from e

    def push(self, ids, grads):
        self._check_error()
        ids = np.ascontiguousarray(_host(ids).ravel(), np.int64)
        grads = np.ascontiguousarray(_host(grads, np.float32)).reshape(
            ids.size, self.table.dim)
        if self.mode == "sync":
            self.table.push(ids, grads)
        elif self.mode in ("async", "half_async"):
            self._q.put((ids, grads))
        else:  # geo: accumulate deltas locally
            for i, g in zip(ids, grads):
                i = int(i)
                if i in self._geo_acc:
                    self._geo_acc[i] = self._geo_acc[i] + g
                else:
                    self._geo_acc[i] = g.copy()
            self._step += 1
            if self._step % self.geo_steps == 0:
                self._flush_geo()

    def _flush_geo(self):
        if not self._geo_acc:
            return
        ids = np.fromiter(self._geo_acc.keys(), np.int64,
                          len(self._geo_acc))
        grads = np.stack([self._geo_acc[int(i)] for i in ids])
        self.table.push(ids, grads)
        self._geo_acc.clear()

    def barrier(self):
        """Drain pending pushes (half-async batch barrier)."""
        if self.mode == "geo":
            self._flush_geo()
        elif self._thread is not None:
            self._q.join()
        self._check_error()

    def stop(self):
        if self._thread is not None:
            self._q.join()
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None


# --------------------------------------------------------------------------
# TCP control plane (listen_and_serv parity)
# --------------------------------------------------------------------------

# -- wire codec ------------------------------------------------------------
# Fixed binary format, parity with the reference's proto wire schema
# (operators/distributed/send_recv.proto.in VariableMessage: name, type,
# dims, serialized tensor bytes).  A tagged value tree — scalars, strings,
# ndarrays (dtype + dims + raw buffer), lists, dicts — with NO embedded
# code paths: decoding can only ever produce data, unlike pickle, so a
# peer that reaches the port cannot gain execution.

_WIRE_MAGIC = b"PT"
_WIRE_VERSION = 1
(_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES, _T_NDARRAY,
 _T_LIST, _T_TUPLE, _T_DICT) = range(10)

_WIRE_DTYPES = {"bool", "int8", "int16", "int32", "int64", "uint8",
                "uint16", "uint32", "uint64", "float16", "float32",
                "float64"}


def _enc(obj, out):
    if obj is None:
        out.append(struct.pack("<B", _T_NONE))
    elif isinstance(obj, bool) or isinstance(obj, np.bool_):
        out.append(struct.pack("<BB", _T_BOOL, bool(obj)))
    elif isinstance(obj, (int, np.integer)):
        out.append(struct.pack("<Bq", _T_INT, int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(struct.pack("<Bd", _T_FLOAT, float(obj)))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(struct.pack("<BI", _T_STR, len(b)))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(struct.pack("<BI", _T_BYTES, len(obj)))
        out.append(bytes(obj))
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        dt = str(a.dtype)
        if dt not in _WIRE_DTYPES:
            raise TypeError(f"dtype {dt} not wire-encodable")
        dtb = dt.encode()
        out.append(struct.pack("<BB", _T_NDARRAY, len(dtb)))
        out.append(dtb)
        out.append(struct.pack("<B", a.ndim))
        out.append(struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(struct.pack("<Q", a.nbytes))
        out.append(a.tobytes())
    elif isinstance(obj, (list, tuple)):
        tag = _T_TUPLE if isinstance(obj, tuple) else _T_LIST
        out.append(struct.pack("<BI", tag, len(obj)))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out.append(struct.pack("<BI", _T_DICT, len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("wire dict keys must be str")
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} not wire-encodable")


def _dec(buf, off):
    (tag,) = struct.unpack_from("<B", buf, off)
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_BOOL:
        (v,) = struct.unpack_from("<B", buf, off)
        return bool(v), off + 1
    if tag == _T_INT:
        (v,) = struct.unpack_from("<q", buf, off)
        return v, off + 8
    if tag == _T_FLOAT:
        (v,) = struct.unpack_from("<d", buf, off)
        return v, off + 8
    if tag in (_T_STR, _T_BYTES):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = bytes(buf[off:off + n])
        if len(raw) != n:
            raise ValueError("truncated wire string")
        return (raw.decode() if tag == _T_STR else raw), off + n
    if tag == _T_NDARRAY:
        (dtl,) = struct.unpack_from("<B", buf, off)
        off += 1
        dt = bytes(buf[off:off + dtl]).decode("ascii")
        off += dtl
        if dt not in _WIRE_DTYPES:
            raise ValueError(f"wire format forbids dtype {dt!r}")
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        expect = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        if nbytes != expect or off + nbytes > len(buf):
            raise ValueError("wire ndarray length mismatch")
        a = np.frombuffer(bytes(buf[off:off + nbytes]), dtype=dt)
        return a.reshape(shape), off + nbytes
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return (tuple(items) if tag == _T_TUPLE else items), off
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            d[k] = v
        return d, off
    raise ValueError(f"unknown wire tag {tag}")


def wire_dumps(obj):
    out = [_WIRE_MAGIC, struct.pack("<B", _WIRE_VERSION)]
    _enc(obj, out)
    return b"".join(out)


def wire_loads(data):
    if len(data) < 3 or data[:2] != _WIRE_MAGIC:
        raise ValueError("bad wire magic (not a paddle_tpu PS frame)")
    if data[2] != _WIRE_VERSION:
        raise ValueError(f"unsupported wire version {data[2]}")
    obj, off = _dec(data, 3)
    if off != len(data):
        raise ValueError("trailing bytes in wire frame")
    return obj


def _send_msg(sock, obj):
    data = wire_dumps(obj)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_msg(sock, max_frame=1 << 34):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    if n > max_frame:
        raise ValueError(f"wire frame of {n} bytes exceeds limit")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return wire_loads(bytes(buf))


class PSServer:
    """One embedding shard behind a TCP endpoint.  The wire format is
    the fixed binary codec above (send_recv.proto.in parity) — pure
    data, no deserialization code paths."""

    def __init__(self, dim, port=0, host="127.0.0.1",
                 heartbeat_timeout=60.0, **shard_kw):
        self.shard = _make_shard(dim, **shard_kw)
        self.monitor = HeartBeatMonitor(timeout=heartbeat_timeout)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = _recv_msg(self.request)
                    except (ConnectionError, EOFError):
                        return
                    op = msg["op"]
                    if op == "pull":
                        _send_msg(self.request,
                                  outer.shard.pull(msg["ids"]))
                    elif op == "push":
                        outer.shard.push(msg["ids"], msg["grads"])
                        _send_msg(self.request, b"ok")
                    elif op == "assign":
                        outer.shard.assign(msg["ids"], msg["vals"])
                        _send_msg(self.request, b"ok")
                    elif op == "export":
                        _send_msg(self.request, outer.shard.export())
                    elif op == "export_full":
                        _send_msg(self.request, outer.shard.export_full())
                    elif op == "assign_full":
                        outer.shard.assign_full(msg["ids"], msg["vals"])
                        _send_msg(self.request, b"ok")
                    elif op == "row_width":
                        _send_msg(self.request, outer.shard.row_width)
                    elif op == "set_lr":
                        outer.shard.set_lr(msg["lr"])
                        _send_msg(self.request, b"ok")
                    elif op == "heartbeat":
                        outer.monitor.beat(msg["worker"])
                        _send_msg(self.request, b"ok")
                    elif op == "dead_workers":
                        _send_msg(self.request, outer.monitor.dead_workers())
                    elif op == "size":
                        _send_msg(self.request, len(outer.shard))
                    elif op == "shutdown":
                        _send_msg(self.request, b"ok")
                        threading.Thread(
                            target=outer.server.shutdown).start()
                        return
                    else:
                        _send_msg(self.request,
                                  {"error": f"unknown op {op}"})

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Srv((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class PSClient:
    """Shard-interface proxy over one PSServer connection."""

    def __init__(self, host, port, dim):
        self.dim = dim
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    def _call(self, **msg):
        with self._lock:
            _send_msg(self._sock, msg)
            return _recv_msg(self._sock)

    def pull(self, ids):
        return self._call(op="pull", ids=_host(ids, np.int64))

    def push(self, ids, grads):
        self._call(op="push", ids=_host(ids, np.int64),
                   grads=_host(grads, np.float32))

    def assign(self, ids, vals):
        self._call(op="assign", ids=_host(ids, np.int64),
                   vals=_host(vals, np.float32))

    def export(self):
        return self._call(op="export")

    def export_full(self):
        return self._call(op="export_full")

    def assign_full(self, ids, vals):
        self._call(op="assign_full", ids=_host(ids, np.int64),
                   vals=_host(vals, np.float32))

    @property
    def row_width(self):
        return int(self._call(op="row_width"))

    def set_lr(self, lr):
        self._call(op="set_lr", lr=float(lr))

    def heartbeat(self, worker_id):
        self._call(op="heartbeat", worker=worker_id)

    def __len__(self):
        return int(self._call(op="size"))

    def shutdown_server(self):
        self._call(op="shutdown")

    def close(self):
        self._sock.close()


class HeartBeatMonitor:
    """Worker-liveness watchdog (heart_beat_monitor.h:70 parity): workers
    ping; stale workers are reported dead after `timeout` seconds."""

    def __init__(self, timeout=60.0):
        self.timeout = timeout
        self._beats = {}
        self._lock = threading.Lock()

    def beat(self, worker_id):
        with self._lock:
            self._beats[worker_id] = time.time()

    def dead_workers(self, now=None):
        now = now if now is not None else time.time()
        with self._lock:
            return [w for w, t in self._beats.items()
                    if now - t > self.timeout]


class ShardedPSClient:
    """Route pulls/pushes across N PSServer endpoints by `id % N` — the
    trainer-side counterpart of the reference's table sharding across
    pservers (transpiler/distribute_transpiler.py slice_vars /
    communicator send routing).  Connections are lazy so the client can
    be constructed before the servers finish binding.  `pull` returns a
    tensor on `device` (None: the card)."""

    def __init__(self, endpoints, dim, device=None):
        from ..core.place import resolve_device

        self.endpoints = list(endpoints)
        self.dim = dim
        self.device = resolve_device(device)
        self._clients = [None] * len(self.endpoints)

    def _client(self, shard):
        if self._clients[shard] is None:
            host, port = self.endpoints[shard].rsplit(":", 1)
            self._clients[shard] = PSClient(host, int(port), self.dim)
        return self._clients[shard]

    def pull(self, ids):
        ids = _host(ids, np.int64)
        flat = ids.reshape(-1)
        n = len(self.endpoints)
        out = np.zeros((flat.size, self.dim), np.float32)
        for s in range(n):
            m = (flat % n) == s
            if m.any():
                out[m] = self._client(s).pull(flat[m])
        return _rows(out.reshape(ids.shape + (self.dim,)), self.device)

    def push(self, ids, grads):
        ids = _host(ids, np.int64)
        flat = ids.reshape(-1)
        g = _host(grads, np.float32).reshape(flat.size, self.dim)
        n = len(self.endpoints)
        for s in range(n):
            m = (flat % n) == s
            if m.any():
                self._client(s).push(flat[m], g[m])

    def close(self):
        for c in self._clients:
            if c is not None:
                try:
                    c._sock.close()
                except OSError:
                    pass
