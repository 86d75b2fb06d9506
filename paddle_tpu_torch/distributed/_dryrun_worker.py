"""One rank of `paddle_tpu_torch.entry.dryrun_multichip`, as spawned by
`launch.start_procs`: `python _dryrun_worker.py <n> <device> <out dir>`
with the trainer env set; rank 0 writes its results as JSON."""

import json
import os
import sys


def main(n, device, out_dir):
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.env import destroy_parallel_env
    from paddle_tpu_torch.entry import dryrun_rank

    torch.set_num_threads(1)
    out = dryrun_rank(int(n), None if device == "cuda" else device)
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(out, f)
    destroy_parallel_env()


if __name__ == "__main__":
    main(*sys.argv[1:4])
