"""The all-finite check (port of `all_finite`,
paddle_tpu/resilience/guard.py:57).

One boolean 0-dim tensor over the float leaves of a nested dict, list or
tuple: the reduction the AMP loss scaler reads.  It stays on the device
(no host sync).  The rest of the reference's guard module (AnomalyGuard
and its policies) is ROADMAP item 10.
"""

import math

import torch

__all__ = ["all_finite"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def all_finite(tree):
    """True when every float leaf is finite.  Non-float tensors (int
    counters) are finite by construction and skipped; Python floats (an
    eagerly accumulated loss) are checked, so float('nan') does not slip
    through.  The result lies on the first checked tensor's device."""
    checks = []
    device = None
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                device = device or x.device
                checks.append(torch.isfinite(x).all())
        elif isinstance(x, float):
            checks.append(torch.tensor(math.isfinite(x)))
    if not checks:
        return torch.tensor(True)
    return torch.stack([c.to(device or c.device) for c in checks]).all()
