"""Serving substrate: the continuous-batching engine (device-side
multi-token decode, paged and contiguous KV caches, live KV migration),
the GLB replica balancer (queued and live steals, replica faults,
predictive balancing), the per-request cost model, the paged KV-cache
pool, the radix prefix cache, the continuous-batching scheduler, and the
fault injector."""
from .cost import (CostModel, CostParams,  # noqa: F401
                   DecodeLengthPredictor)
from .engine import (Engine, GLBReplicaBalancer, Migration,  # noqa: F401
                     Request)
from .faults import Fault, FaultInjector  # noqa: F401
from .kvpool import KVPool, PoolExhausted, PoolStats  # noqa: F401
from .radix import RadixPrefixCache  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, StepPlan  # noqa: F401
