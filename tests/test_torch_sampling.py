"""Temperature sampling of the port against the JAX package, by distribution.

``repro_torch.models.lm.sample_tokens`` draws Gumbel-max on torch
uniforms; ``repro.models.lm.sample_tokens`` calls
``jax.random.categorical``. The two streams of random numbers differ, so
the draws are compared as distributions: each package draws N = 20,000
times on the same fixed logits at a temperature T, and

* each token's count c is held to its expectation under
  ``softmax(logits / T)``: |c - N p| <= 5 sqrt(N p (1 - p)) + 1, five
  binomial standard deviations (the +1 covers tokens whose expected count
  is below one);
* the two packages' counts are held to each other: |c_torch - c_jax| <=
  5 sqrt(2 N p (1 - p)) + 1, the difference of two independent binomial
  counts.

A fair sampler fails one of these bounds with a probability under 1e-6
per token and temperature; the seeds are fixed, so a run is
deterministic. At T = 0 both take the first maximum.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.lm import sample_tokens as jax_sample
from repro_torch.models.lm import sample_tokens as torch_sample

N = 20_000
LOGITS = np.asarray([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -3.0, 0.25, 1.0],
                    np.float32)
SIGMAS = 5.0


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _counts(temperature):
    logits = np.broadcast_to(LOGITS, (N, LOGITS.size))
    ids_t = torch_sample(torch.from_numpy(logits.copy()),
                         generator=torch.Generator().manual_seed(0),
                         temperature=temperature)
    ids_j = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                       temperature=temperature)
    assert tuple(ids_t.shape) == (N,) and ids_t.dtype == torch.int32
    assert np.asarray(ids_j).shape == (N,)
    return (np.bincount(ids_t.numpy(), minlength=LOGITS.size),
            np.bincount(np.asarray(ids_j), minlength=LOGITS.size))


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sampling_matches_softmax_and_the_reference(temperature):
    c_torch, c_jax = _counts(temperature)
    p = _softmax(LOGITS.astype(np.float64) / temperature)
    sd = np.sqrt(N * p * (1 - p))
    for name, c in (("torch", c_torch), ("jax", c_jax)):
        assert c.sum() == N
        excess = np.abs(c - N * p) - (SIGMAS * sd + 1)
        assert (excess <= 0).all(), (name, c, N * p)
    assert (np.abs(c_torch - c_jax) <= SIGMAS * np.sqrt(2) * sd + 1).all(), (
        c_torch, c_jax)


def test_sampling_tracks_the_temperature():
    """Hotter draws spread out: the top token's share falls with T in both
    packages, as softmax(logits / T) says."""
    tops = [[c[0] / N for c in _counts(t)] for t in (0.5, 1.0, 2.0)]
    for i in range(2):
        assert tops[0][i] > tops[1][i] > tops[2][i]


def test_zero_temperature_takes_the_first_maximum():
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 3, (64, 12)).astype(np.float32)   # ties
    got = torch_sample(torch.from_numpy(logits))
    want = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
