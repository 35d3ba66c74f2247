"""Per-request cost model: predicted remaining block-seconds for
predictive, cost-weighted load balancing (DESIGN.md §16). A copy of
``repro.serve.cost``: the balancer's decisions depend on these numbers,
so they are part of the port's parity with the JAX package.

Without a cost model the fabric balancer is purely *reactive*: a replica
steals only once it is already starving, and it steals by queue depth —
every request counts as 1 regardless of how expensive it actually is.
Related work names the two missing halves:
anticipate imbalance before it lands (arXiv 1909.07168) and treat
requests as indivisible real-valued loads diffused toward a balanced
state (arXiv 1308.0148). Both need the same primitive: a **cost
estimate per request**, so load can be balanced on predicted work
rather than on counts.

This module provides that primitive from three observable inputs:

* **prompt tokens** — known exactly at submit;
* **radix prefix-cache hit length** — tokens the engine will serve from
  cached KV blocks instead of recomputing (``RadixPrefixCache.
  hit_length``), known at estimate time per target replica;
* **predicted decode length** — drawn from a running per-tenant
  decode-length :class:`~repro_torch.obs.metrics.Histogram` that updates
  online as requests finish. A tenant with too few samples falls back
  to the *global* histogram (all tenants pooled), and a cold fabric
  falls back to a configured prior — so the model always answers, and
  its answers sharpen as traffic flows.

The unit is **block-seconds**: KV pool blocks the request will occupy ×
the estimated seconds of accelerator work remaining (calibrated by
``us_per_prefill_token`` / ``us_per_decode_token``). The deliberate
simplification — occupancy is taken at the request's *final* footprint
rather than integrated over its growth — keeps the estimate monotone in
all three inputs and cheap enough to recompute every balance pass; the
balancer only ever compares costs, so a consistent over-approximation
cancels out.

Every prediction is stamped on the request (``req.predicted_decode``)
and scored when the request finishes: absolute error feeds an error
histogram, a ``cost_sample`` trace instant carries (predicted, actual,
tenant) for the analyzer's prediction-error attribution
(``obs.analyze``), and the finished length feeds the tenant histogram —
closing the online-learning loop. The reactive-parity contract
(DESIGN.md §16) is enforced upstream: a balancer *without* a cost model
takes code paths this module never touches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram

# Decode-length buckets in TOKENS (not ms): geometric 1..4096, tight at
# the short end where chat-style turns cluster. Fixed across tenants so
# per-tenant histograms merge exactly, same contract as the ms buckets.
DECODE_LEN_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0, 96.0,
    128.0, 192.0, 256.0, 384.0, 512.0, 768.0, 1024.0, 2048.0, 4096.0,
)
# Absolute prediction-error buckets (tokens).
ERROR_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                 256.0, 512.0, 1024.0)


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Calibration + policy knobs for the cost model.

    ``us_per_prefill_token`` / ``us_per_decode_token`` convert token
    counts into service time (decode is far more expensive per token
    than batched prefill). Their defaults (50 / 400 µs, prior 64
    tokens) are the reference's policy constants, measured on no chip:
    the balancer only compares costs, so their ratio matters, and
    keeping them keeps the port's decisions equal to the reference's
    (``chip_smoke.py`` prints the H100's own service times beside them);
    ``prior_decode_tokens`` is the cold-start
    decode-length guess used before ANY request has finished;
    ``quantile`` is the point estimate drawn from the length histogram
    (0.5 = median — robust to the long tail; raise it to plan
    pessimistically); ``min_samples`` is how many finishes a tenant
    needs before its own histogram outvotes the global one."""

    us_per_prefill_token: float = 50.0
    us_per_decode_token: float = 400.0
    prior_decode_tokens: float = 64.0
    quantile: float = 0.5
    min_samples: int = 3

    def __post_init__(self):
        if self.us_per_prefill_token <= 0 or self.us_per_decode_token <= 0:
            raise ValueError("per-token costs must be positive")
        if self.prior_decode_tokens <= 0:
            raise ValueError("prior_decode_tokens must be positive")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0,1): {self.quantile}")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")


class DecodeLengthPredictor:
    """Running per-tenant decode-length distribution.

    One fixed-bucket :class:`Histogram` (token-valued) per tenant plus
    one global histogram pooling every tenant. ``predict(tenant)``
    returns the configured quantile of the best-informed distribution:
    the tenant's own once it has ``min_samples`` finished requests, the
    global one once the *fabric* has that many, and the configured
    prior before that — the cold-start path. ``observe`` is O(1); the
    predictor carries no per-request state."""

    def __init__(self, params: CostParams = CostParams()):
        self.params = params
        self._tenants: Dict[str, Histogram] = {}
        self._global = Histogram(DECODE_LEN_BUCKETS)

    def observe(self, tenant: str, decoded_tokens: int) -> None:
        """Fold one finished request's decode length into the tenant's
        and the global distribution (the online update)."""
        h = self._tenants.get(tenant)
        if h is None:
            h = self._tenants[tenant] = Histogram(DECODE_LEN_BUCKETS)
        h.observe(float(decoded_tokens))
        self._global.observe(float(decoded_tokens))

    def samples(self, tenant: str) -> int:
        """Finished-request count backing ``tenant``'s own histogram."""
        h = self._tenants.get(tenant)
        return h.count if h is not None else 0

    def predict(self, tenant: str) -> float:
        """Predicted decode length (tokens) for the next request from
        ``tenant``: tenant quantile → global quantile → prior."""
        p = self.params
        h = self._tenants.get(tenant)
        if h is not None and h.count >= p.min_samples:
            return h.quantile(p.quantile)
        if self._global.count >= p.min_samples:
            return self._global.quantile(p.quantile)
        return p.prior_decode_tokens

    def source(self, tenant: str) -> str:
        """Which distribution ``predict`` would answer from right now:
        ``"tenant"``, ``"global"``, or ``"prior"`` (cold start)."""
        p = self.params
        h = self._tenants.get(tenant)
        if h is not None and h.count >= p.min_samples:
            return "tenant"
        if self._global.count >= p.min_samples:
            return "global"
        return "prior"


class CostModel:
    """Request-cost estimator + online prediction-error tracker.

    ``estimate(...)`` prices a request's REMAINING work in
    block-seconds; ``observe_finish(req)`` closes the loop when the
    request completes — scoring the prediction stamped at submit and
    feeding the actual length back into the predictor. One model is
    shared fabric-wide (like the tracer and the SLO monitor): every
    replica's finishes sharpen every replica's predictions."""

    def __init__(self, params: CostParams = CostParams(),
                 predictor: Optional[DecodeLengthPredictor] = None):
        self.params = params
        self.predictor = (predictor if predictor is not None
                          else DecodeLengthPredictor(params))
        self.error_hist = Histogram(ERROR_BUCKETS)
        # Chronological |predicted - actual| per finished request: the
        # convergence trace ("does the error shrink over a run?") used
        # by tests, the bench row, and the analyzer cross-check.
        self.errors: List[float] = []
        self.predictions = 0

    # ------------------------------------------------------------ pricing
    def predict_decode(self, tenant: str, max_new: int,
                       generated: int = 0) -> float:
        """Predicted TOTAL decode length for one request, clipped to
        what is still possible: at least the tokens already generated
        (the request demonstrably reached that length) and at most its
        ``max_new`` budget."""
        raw = self.predictor.predict(tenant)
        return float(min(max(raw, float(generated)), float(max_new)))

    def service_us(self, prefill_tokens: int, decode_tokens: float) -> float:
        """Calibrated service time (µs) for a given amount of prefill
        and decode work."""
        p = self.params
        return (prefill_tokens * p.us_per_prefill_token
                + decode_tokens * p.us_per_decode_token)

    def prefill_ms(self, prefill_tokens: int) -> float:
        """Predicted prefill service time in ms (the SLO admission
        slack term: time-to-first-token ≈ queue wait + this)."""
        return prefill_tokens * self.params.us_per_prefill_token / 1e3

    def estimate(self, prompt_tokens: int, cached_tokens: int,
                 generated: int, tenant: str, max_new: int,
                 block_size: int) -> float:
        """Predicted remaining block-seconds for one request.

        ``prompt_tokens`` is the (bucket-truncated) prompt length,
        ``cached_tokens`` the radix prefix-cache hit length (tokens the
        target replica would serve from cached blocks — 0 when there is
        no cache), ``generated`` the tokens already produced (0 for a
        queued request; >0 prices only the remaining decode of a
        running one). Monotone: longer prompts, colder caches, and
        longer predicted decodes all cost more."""
        predicted = self.predict_decode(tenant, max_new, generated)
        prefill_left = (0 if generated
                        else max(prompt_tokens - cached_tokens, 0))
        decode_left = max(predicted - generated, 1.0)
        final_tokens = prompt_tokens + predicted
        blocks = max(-(-final_tokens // max(block_size, 1)), 1.0)
        secs = self.service_us(prefill_left, decode_left) / 1e6
        return blocks * secs

    # ----------------------------------------------------- online updates
    def stamp(self, req) -> float:
        """Stamp the at-submit decode-length prediction on ``req`` (once
        — re-submits after steals/migrations keep the original stamp,
        exactly like ``t_submit``). Returns the stamped prediction."""
        if getattr(req, "predicted_decode", -1.0) < 0:
            req.predicted_decode = self.predict_decode(
                req.tenant, req.max_new, len(req.out))
            self.predictions += 1
        return req.predicted_decode

    def observe_finish(self, req) -> Optional[float]:
        """Score and learn from one finished request: absolute
        prediction error (tokens) into the error histogram and trace,
        actual length into the tenant histogram. Returns the error, or
        None when the request was never stamped (model attached
        mid-run)."""
        actual = len(req.out)
        err = None
        if getattr(req, "predicted_decode", -1.0) >= 0:
            err = abs(req.predicted_decode - actual)
            self.error_hist.observe(err)
            self.errors.append(err)
        self.predictor.observe(req.tenant, actual)
        return err

    # ------------------------------------------------------------- stats
    def mean_abs_error(self) -> float:
        """All-time mean |predicted - actual| in tokens."""
        return self.error_hist.mean

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric view for ``collect()``-style merging."""
        half = len(self.errors) // 2
        early = (sum(self.errors[:half]) / half) if half else 0.0
        late = (sum(self.errors[half:]) / max(len(self.errors) - half, 1)
                if self.errors else 0.0)
        return {
            "cost_predictions": float(self.predictions),
            "cost_samples": float(len(self.errors)),
            "cost_mean_abs_err_tokens": round(self.mean_abs_error(), 3),
            "cost_early_abs_err_tokens": round(early, 3),
            "cost_late_abs_err_tokens": round(late, 3),
        }
