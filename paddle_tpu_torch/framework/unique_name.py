"""Unique name generator (port of paddle_tpu/framework/unique_name.py).

Paddle-Fluid's `unique_name` (fluid/unique_name.py): per-prefix counters
with guard support for reproducible naming.  The port's counters name
variables exactly as the reference's do, which `Program.to_json` relies
on to serialize the same bytes.
"""

import contextlib


class UniqueNameGenerator:
    def __init__(self):
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        n = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{n}"


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def generate_with_ignorable_key(key):
    """unique_name.py:123 parity — same counter space; the reference's
    "ignorable" prefix only matters to its dygraph name checker."""
    return generator(key)


def switch(new_generator=None):
    """unique_name.py:131 parity — swap the global generator, returning
    the previous one so callers can restore it."""
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
