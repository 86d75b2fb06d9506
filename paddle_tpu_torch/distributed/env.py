"""Process environment and rendezvous (port of paddle_tpu/distributed/env.py).

The trainer env contract is the reference's: PADDLE_TRAINER_ID (this
process's rank), PADDLE_TRAINERS_NUM (the world size),
PADDLE_TRAINER_ENDPOINTS (every rank's host:port, rank 0's first) and
PADDLE_CURRENT_ENDPOINT, as `launch` sets them.  `init_parallel_env`
joins the `torch.distributed` process group those name:

- NCCL by default (one rank per card, the card `rank % device_count`);
  gloo when the caller asks for the CPU (`device="cpu"`);
- several ranks rendezvous at `tcp://<endpoints[0]>`;
- with no env it makes a world of one over an in-process store, which on
  the card is still a real NCCL group;
- PADDLE_RENDEZVOUS_TIMEOUT (seconds) bounds the rendezvous and every
  collective, as the reference bounds `jax.distributed.initialize`.
"""

import datetime
import os

import torch
import torch.distributed as dist

from ..core.place import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "destroy_parallel_env",
           "get_rank", "get_world_size"]


class ParallelEnv:
    """Parity: dygraph/parallel.py:54."""

    def __init__(self):
        self._nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._local_rank

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._endpoints.split(",") if self._endpoints else []


def _device_of(device, rank):
    """The device this rank's tensors live on: `device` when given,
    else the card `rank % device_count` (raises without a card)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_parallel_env(device=None):
    """Join the process group of the trainer env (see the module
    docstring) once per process; returns the ParallelEnv."""
    env = ParallelEnv()
    if dist.is_initialized():
        return env
    dev = _device_of(device, env.local_rank)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    timeout = os.environ.get("PADDLE_RENDEZVOUS_TIMEOUT")
    if timeout:
        kwargs["timeout"] = datetime.timedelta(seconds=int(timeout))
    if env.nranks > 1:
        if not env.trainer_endpoints:
            raise RuntimeError(
                f"PADDLE_TRAINERS_NUM={env.nranks} needs "
                "PADDLE_TRAINER_ENDPOINTS (rank 0's host:port first)")
        dist.init_process_group(
            backend, init_method=f"tcp://{env.trainer_endpoints[0]}",
            world_size=env.nranks, rank=env.local_rank, **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kwargs)
    return env


def destroy_parallel_env():
    """Leave the process group (and forget the global mesh built on
    it); a later `init_parallel_env` joins anew."""
    from . import mesh

    mesh.set_global_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1
