"""Parameters and their initialization (port of paddle_tpu/nn/parameter.py).

A parameter is a `torch.nn.Parameter`.  Initial values are drawn on the
host from an explicit `torch.Generator` and then moved to the layer's
device, so a seed gives the same weights on any device.  The draws
follow the reference's initializers in distribution (Xavier-uniform
weights, constant norms and biases), not in bits: JAX's threefry and
torch's generators never agree, which is why the tests carry weights
across as numpy arrays (`paddle_tpu_torch.interop`).
"""

import contextlib
import math
import threading

import torch

from ..core.dtype import to_torch_dtype


def make_generator(seed=0, device="cpu"):
    """A torch.Generator on `device` (the host by default) seeded with
    `seed`: the port's counterpart of a reference PRNG key."""
    return torch.Generator(device=device).manual_seed(int(seed))


def rewound(fn, generator):
    """`fn` for non-reentrant `torch.utils.checkpoint`: the first call
    (the forward) draws from `generator` as it stands; each later call
    (the recompute in the backward) draws from `generator` rewound to
    where the first call started, and leaves it where it was, so the
    recompute draws the forward's random bits and the draws after it do
    not see the recompute."""
    start = generator.get_state()
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    return run


class _DropoutRng:
    """Where dropout draws its random bits: the port's counterpart of the
    reference's `default_rng`.

    Inside `key_context(generator)` (the train step enters it with the
    generator its TrainState holds, as the reference enters its traced
    key) every draw on this thread comes from that generator.  Outside
    it, draws come from one generator per device, seeded by `seed()`
    (0 until then), never from torch's global RNG."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seed = 0
        self._per_device = {}
        self._local = threading.local()

    def seed(self, s):
        with self._lock:
            self._seed = int(s)
            self._per_device.clear()

    @contextlib.contextmanager
    def key_context(self, generator):
        old = getattr(self._local, "override", None)
        self._local.override = generator
        try:
            yield
        finally:
            self._local.override = old

    def generator(self, device):
        """The generator a draw on `device` takes."""
        override = getattr(self._local, "override", None)
        if override is not None:
            return override
        device = torch.device(device)
        with self._lock:
            gen = self._per_device.get(device)
            if gen is None:
                gen = make_generator(self._seed, device)
                self._per_device[device] = gen
            return gen


default_rng = _DropoutRng()


def seed(s):
    """Parity: fluid.dygraph seed / paddle.seed (dropout draws)."""
    default_rng.seed(s)
    return default_rng


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


def xavier_uniform(shape, generator):
    fan_in, fan_out = _fan_in_out(tuple(shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-limit, limit,
                                              generator=generator)


def materialize(shape, dtype, device, generator, constant=None):
    """Initial value of one parameter: `constant` fills it, otherwise
    Xavier-uniform from `generator`; drawn in f32 on the host, then cast
    and moved."""
    if constant is not None:
        value = torch.full(tuple(shape), float(constant))
    else:
        value = xavier_uniform(shape, generator)
    return torch.nn.Parameter(value.to(device=device,
                                       dtype=to_torch_dtype(dtype)))
