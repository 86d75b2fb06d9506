"""Multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``.

Port of paddle_tpu/distributed/launch.py (the reference's launch.py:175
contract).  `start_procs` spawns one worker per rank with the trainer
env (PADDLE_TRAINER_ID, PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINER_ENDPOINTS,
PADDLE_TRAINERS_NUM, FLAGS_selected_devices) and an optional log dir;
`_wait` watches them and, when one fails, terminates the rest.  Worker
0's endpoint is the rendezvous address of `env.init_parallel_env`.

On the card the port runs one process per GPU (`--nproc_per_node` = the
cards of the node; NCCL needs a card per rank).  On the CPU, workers on
localhost that call `init_parallel_env(device="cpu")` form a gloo group,
which is how the tests get multi-process worlds.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py [args...]
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "start_procs", "find_free_ports"]


def find_free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="spawn distributed training workers "
                    "(launch.py:175 parity)")
    p.add_argument("--cluster_node_ips", default="127.0.0.1",
                   help="comma-separated host ips")
    p.add_argument("--node_ip", default="127.0.0.1",
                   help="this node's ip")
    p.add_argument("--started_port", type=int, default=None)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="workers per node (one per card)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def start_procs(node_ips, node_ip, nproc_per_node, training_script,
                script_args=(), started_port=None, log_dir=None,
                env_extra=None):
    """Spawn nproc_per_node workers for THIS node; returns (procs, logs).

    The endpoint list covers every node so each worker sees the global
    cluster (PADDLE_TRAINER_ENDPOINTS), while PADDLE_TRAINER_ID counts
    globally across nodes — the reference's contract."""
    node_ips = list(node_ips)
    if started_port is None:
        if len(node_ips) > 1:
            # every node must compute the SAME global endpoint list, so
            # multi-node runs need a deterministic port (reference default
            # 6170, launch.py); random free ports are single-node only
            started_port = 6170
            ports = [started_port + i for i in range(nproc_per_node)]
        else:
            ports = find_free_ports(nproc_per_node)
    else:
        ports = [started_port + i for i in range(nproc_per_node)]
    endpoints = [f"{ip}:{port}" for ip in node_ips for port in ports]
    node_idx = node_ips.index(node_ip)
    nranks = len(node_ips) * nproc_per_node

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    for local_i in range(nproc_per_node):
        rank = node_idx * nproc_per_node + local_i
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_TRAINERS_NUM": str(nranks),
            "FLAGS_selected_devices": str(local_i),
        })
        env.update(env_extra or {})
        log_f = None
        if log_dir:
            log_f = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
            logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", training_script, *script_args],
            env=env, stdout=log_f, stderr=subprocess.STDOUT if log_f
            else None))
    return procs, logs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait(procs, logs, timeout=None):
    """Wait for all workers; on any failure terminate the rest (launch.py
    watch loop parity).  With `timeout` (seconds), workers still running
    then are killed and the result is 124.  Returns 0 or the first
    non-zero exit code."""
    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        alive = set(range(len(procs)))
        while alive:
            for i in list(alive):
                r = procs[i].poll()
                if r is None:
                    continue
                alive.discard(i)
                if r != 0:
                    rc = r
                    _stop([procs[j] for j in alive])
                    alive = set()
                    break
            if alive and deadline is not None \
                    and time.monotonic() > deadline:
                _stop([procs[j] for j in alive])
                return 124
            time.sleep(0.1)
    finally:
        for f in logs:
            f.close()
    return rc


def launch(argv=None):
    args = _parse_args(argv)
    node_ips = args.cluster_node_ips.split(",")
    procs, logs = start_procs(
        node_ips, args.node_ip, args.nproc_per_node,
        args.training_script, args.training_script_args,
        started_port=args.started_port, log_dir=args.log_dir)
    return _wait(procs, logs)


if __name__ == "__main__":
    sys.exit(launch())
