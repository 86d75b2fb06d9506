"""Federated learning: FedAvg rounds over the parameter server's wire
(port of paddle_tpu/distributed/federated.py).

Parity: paddle/fluid/operators/distributed_ops/fl_listen_and_serv_op.cc —
the reference's federated server is a listen_and_serv variant that
collects client-trained parameters each round and averages them.  Here
the server is a small TCP service speaking ps.py's wire format
(`_send_msg` / `_recv_msg`), holding the global dense model; clients run
local train steps on private data, push sample-weighted parameter
updates (torch tensors or numpy arrays) and block on the next global
round.  Federation is host-side control plane only: no graph surgery.
"""

import socket
import socketserver
import threading

import numpy as np

from .ps import _host, _recv_msg, _send_msg


def _tree_avg(updates):
    """Sample-weighted average of [(params_dict, n_samples), ...]."""
    total = float(sum(n for _, n in updates))
    keys = updates[0][0].keys()
    out = {}
    for k in keys:
        acc = None
        for params, n in updates:
            term = np.asarray(params[k], np.float32) * (n / total)
            acc = term if acc is None else acc + term
        out[k] = acc
    return out


class FLServer:
    """FedAvg coordinator: one round = every registered client pushes a
    (params, n_samples) update; the server averages and bumps the model
    version (fl_listen_and_serv's aggregate step)."""

    def __init__(self, init_params, num_clients, port=0, host="127.0.0.1"):
        self.params = {k: _host(v, np.float32)
                       for k, v in init_params.items()}
        self.num_clients = int(num_clients)
        self.version = 0
        self._pending = []
        self._cond = threading.Condition()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = _recv_msg(self.request)
                    except (ConnectionError, EOFError):
                        return
                    op = msg["op"]
                    if op == "get_model":
                        with outer._cond:
                            _send_msg(self.request,
                                      {"version": outer.version,
                                       "params": outer.params})
                    elif op == "push_update":
                        with outer._cond:
                            outer._pending.append(
                                (msg["params"], msg["num_samples"]))
                            if len(outer._pending) >= outer.num_clients:
                                outer.params = _tree_avg(outer._pending)
                                outer._pending = []
                                outer.version += 1
                                outer._cond.notify_all()
                        _send_msg(self.request, b"ok")
                    elif op == "wait_version":
                        want = msg["version"]
                        with outer._cond:
                            ok = outer._cond.wait_for(
                                lambda: outer.version >= want,
                                timeout=msg.get("timeout", 120.0))
                            _send_msg(self.request,
                                      {"version": outer.version,
                                       "params": outer.params,
                                       "timed_out": not ok})
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


class FLClient:
    """Client-side proxy: pull the global model, push a local update,
    block for the next aggregated round."""

    def __init__(self, host, port):
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    def _call(self, **msg):
        with self._lock:
            _send_msg(self._sock, msg)
            return _recv_msg(self._sock)

    def get_model(self):
        r = self._call(op="get_model")
        return r["version"], r["params"]

    def push_update(self, params, num_samples):
        self._call(op="push_update",
                   params={k: _host(v, np.float32)
                           for k, v in params.items()},
                   num_samples=int(num_samples))

    def wait_version(self, version, timeout=120.0):
        r = self._call(op="wait_version", version=version, timeout=timeout)
        if r.get("timed_out"):
            raise TimeoutError(
                f"wait_version({version}) timed out after {timeout}s; "
                f"server is still at version {r['version']}")
        return r["version"], r["params"]

    def shutdown_server(self):
        self._call(op="shutdown")

    def close(self):
        self._sock.close()


def run_fl_round(client, local_train_fn, num_samples):
    """One client-side FedAvg round: pull -> local train -> push -> wait.

    local_train_fn(params) -> new_params runs the client's private
    optimization (typically several train steps).
    Returns (new_version, new_global_params).
    """
    version, params = client.get_model()
    new_params = local_train_fn(params)
    client.push_update(new_params, num_samples)
    return client.wait_version(version + 1)
