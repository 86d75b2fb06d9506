"""This process's fleet identity, stamped on every telemetry line and
flight dump (the part of paddle_tpu/monitor/fleet.py the serving tier
needs; the straggler probe and skew table are ROADMAP item 10).

The launcher's environment is the truth: torch.distributed's `RANK` /
`WORLD_SIZE`, else the reference launcher's `PADDLE_TRAINER_ID` /
`PADDLE_TRAINERS_NUM`.
"""

import os
import socket

__all__ = ["rank_info", "rank_tag"]

_INFO = None


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            try:
                return int(v)
            except ValueError:
                pass
    return default


def rank_info():
    """``{host, pid, process_index, process_count}`` (built once)."""
    global _INFO
    if _INFO is None or _INFO["pid"] != os.getpid():
        _INFO = {
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "process_index": _env_int("RANK", "PADDLE_TRAINER_ID",
                                      default=0),
            "process_count": _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM",
                                      default=1),
        }
    return dict(_INFO)


def rank_tag():
    """The compact stamp: ``{host, process_index}``."""
    info = rank_info()
    return {"host": info["host"], "process_index": info["process_index"]}
