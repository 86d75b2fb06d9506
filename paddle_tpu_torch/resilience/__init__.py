"""Resilience (port of the part of paddle_tpu/resilience/ that AMP
needs: `guard.all_finite`).  The anomaly guard, its policies, elastic
training and fault injection are ROADMAP item 10."""

from .guard import all_finite  # noqa: F401

__all__ = ["all_finite"]
