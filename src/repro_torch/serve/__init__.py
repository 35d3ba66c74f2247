"""Serving substrate: the continuous-batching engine (device-side
multi-token decode, paged and contiguous KV caches), the paged KV-cache
pool, the radix prefix cache and the continuous-batching scheduler."""
from .engine import Engine, Request  # noqa: F401
from .kvpool import KVPool, PoolExhausted, PoolStats  # noqa: F401
from .radix import RadixPrefixCache  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, StepPlan  # noqa: F401
