"""One AdamW training step of the port against the JAX package's
``make_train_step``, for the dense and moe families (the smoke configs of
tinyllama-1.1b and moonshot-v1-16b-a3b at capacity 1.25, float32), with
one microbatch and with two (the gradients summed in float32 and
divided, ``expert_counts`` summed, the other metrics averaged).

Weights come from the reference's ``init_lm`` through
``params_from_jax(dtype=float32)``, the batch from its ``SyntheticTokens``.

Tolerances, all derived from the gradients' (1e-5 + 1e-4 x the leaf's max
|grad|, ``test_torch_train.py``), with g the clipped gradient that the
reference's first moment implies (m = (1 - b1) g):
- metrics: losses to rtol 1e-5, ``grad_norm`` to rtol 1e-5, ``lr`` to
  rtol 1e-6; the step and the MoE counts equal;
- m: (1 - b1) x the gradient tolerance; v: (1 - b2) x (2 max|g| tol +
  tol^2);
- parameters: the first update is about lr x sign(g), whatever |g|, so an
  entry whose g lies inside the gradient tolerance may move the other
  way. Every entry outside that band agrees to 1e-6 (float32 rounding of
  p - lr u). Inside it (about 1.3% of tinyllama's entries, mostly in the
  head, whose gradients are heavy-tailed) an entry may differ by at most
  2 lr (a flipped sign), and the entries that differ by more than 1e-6
  must be fewer than 0.1% of the parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.train.optimizer import OptConfig, adamw_init
from repro.train.trainer import make_train_step
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.train.optimizer import OptConfig as T_OptConfig
from repro_torch.train.optimizer import adamw_init as t_adamw_init
from repro_torch.train.trainer import make_train_step as t_make_train_step
from repro_torch.weights import params_from_jax, params_to_jax
from test_torch_train import (batch_of, jax_tree, one_thread,  # noqa: F401
                              to_torch)

pytestmark = pytest.mark.usefixtures("one_thread")

OC = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_adamw_step_matches_jax(arch, microbatches):
    cfg, tcfg = ARCHS[arch].smoke(), T_ARCHS[arch].smoke()
    tree = jax_tree(cfg)
    batch = batch_of(cfg, B=4)
    oc = OptConfig(**OC)
    jp = jax.tree.map(jnp.asarray, tree)
    jparams, jopt, jm = jax.jit(make_train_step(cfg, oc, microbatches))(
        jp, adamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    step = t_make_train_step(tcfg, T_OptConfig(**OC), microbatches)
    params, opt, tm = step(params, t_adamw_init(params), to_torch(batch))

    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        if k == "expert_counts":
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(float(tm[k]), float(v),
                                       rtol=1e-6 if k == "lr" else 1e-5,
                                       err_msg=k)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    assert opt["step"].dtype == torch.int32

    b1, b2 = oc.b1, oc.b2
    scale = min(1.0, oc.clip_norm / max(float(jm["grad_norm"]), 1e-9))
    left_out = total = 0
    for p_t, p_j, m_t, m_j, v_t, v_j in zip(
            _leaves(params_to_jax(params)), _leaves(jparams),
            _leaves(params_to_jax(opt["m"])), _leaves(jopt["m"]),
            _leaves(params_to_jax(opt["v"])), _leaves(jopt["v"]),
            strict=True):
        g = m_j / (1 - b1)                          # the clipped gradient
        gmax = np.abs(g).max()
        tol = scale * 1e-5 + 1e-4 * gmax
        np.testing.assert_allclose(m_t, m_j, rtol=0, atol=(1 - b1) * tol)
        np.testing.assert_allclose(
            v_t, v_j, rtol=0, atol=(1 - b2) * (2 * gmax * tol + tol * tol))
        near = np.abs(g) <= tol
        total += g.size
        np.testing.assert_allclose(p_t[~near], p_j[~near], rtol=0, atol=1e-6)
        np.testing.assert_allclose(p_t[near], p_j[near], rtol=0,
                                   atol=2 * float(jm["lr"]) + 1e-6)
        left_out += int((np.abs(p_t - p_j)[near] > 1e-6).sum())
    assert left_out < 1e-3 * total, (left_out, total)


def test_second_step_continues_the_state():
    """Two port steps: the moments carry over and the step counts on."""
    arch = "tinyllama-1.1b"
    tcfg = T_ARCHS[arch].smoke()
    params = params_from_jax(jax_tree(ARCHS[arch].smoke()), tcfg,
                             device="cpu", dtype=torch.float32)
    opt = t_adamw_init(params)
    step = t_make_train_step(tcfg, T_OptConfig(**OC))
    b = to_torch(batch_of(tcfg, B=4))
    params, opt, m1 = step(params, opt, b)
    m_first = opt["m"]["embed"].clone()
    params, opt, m2 = step(params, opt, b)
    assert int(opt["step"]) == 2
    assert float(m2["lr"]) > float(m1["lr"])                   # warmup
    assert float(m2["loss"]) < float(m1["loss"])
    assert not torch.equal(opt["m"]["embed"], m_first)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_prefill_and_decode_steps_match_jax(arch):
    """make_prefill_step / make_decode_step: the greedy next token of a
    prompt and of three decode steps after it, as the reference's."""
    from repro.train.trainer import make_decode_step, make_prefill_step
    from repro_torch.train.trainer import make_decode_step as t_decode
    from repro_torch.train.trainer import make_prefill_step as t_prefill

    cfg, tcfg = ARCHS[arch].smoke(), T_ARCHS[arch].smoke()
    tree = jax_tree(cfg)
    toks = np.random.default_rng(4).integers(2, cfg.vocab, (2, 12)).astype(
        np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, tcfg, device="cpu")
    want, jcache = make_prefill_step(cfg, 32)(jp, {"tokens": toks})
    got, cache = t_prefill(tcfg, 32)(params, {"tokens": torch.from_numpy(
        toks)})
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jstep, step = make_decode_step(cfg), t_decode(tcfg)
    for i in range(3):
        want, jcache = jstep(jp, want.astype(jnp.int32), jcache,
                             jnp.int32(12 + i))
        got, cache = step(params, got.to(torch.int32), cache, 12 + i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
