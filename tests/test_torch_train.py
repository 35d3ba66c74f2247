"""The port's training loss and gradients against the JAX package.

For each of the six families (the smoke configs of tinyllama-1.1b,
moonshot-v1-16b-a3b at its own capacity 1.25, with drops, mamba2-130m,
zamba2-7b, qwen2-vl-2b and musicgen-medium; float32), the weights are made
by the reference's ``init_lm`` (norm scales, biases and Mamba2's scalars
set to random values so that each matters) and carried over by
``params_from_jax(dtype=float32)``; the batch is the reference's
``SyntheticTokens``. ``train_loss`` and every metric, and the gradient of
every parameter, are held against ``jax.value_and_grad``.

Tolerances: the loss to rtol 1e-5 (float32, two layers); each gradient
leaf to 1e-5 + 1e-4 x the leaf's max |grad| (float32 sums in another
order through the backward). The MoE routing statistics are equal.

Also here: the three remat policies give equal gradients, ``cosine_lr``
equals the reference's, and ``KernelFunction`` (the autograd route the
kernels take on the card) gives the plain version's gradients when the
plain version stands in for the launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.data.pipeline import SyntheticTokens
from repro.models import init_lm, train_loss
from repro.train.optimizer import OptConfig, cosine_lr
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.kernels.autograd import KernelFunction, needs_grad
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.mamba2_ssd import ssd_chunked_ref
from repro_torch.kernels.moe_gmm import gmm_ref
from repro_torch.train.optimizer import OptConfig as T_OptConfig
from repro_torch.train.optimizer import cosine_lr as t_cosine_lr
from repro_torch.train.trainer import loss_and_grads
from repro_torch.weights import params_from_jax, params_to_jax

FAMILIES = {"dense": "tinyllama-1.1b", "moe": "moonshot-v1-16b-a3b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
            "vlm": "qwen2-vl-2b", "audio": "musicgen-medium"}
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def one_thread():
    """PyTorch on one thread for the test: the suite runs several workers
    on the machine's cores, and many small ops on a full thread pool each
    then wait for the others' threads (a training loop of a tiny model
    ran 20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Leaves that init_lm sets to zero or one; randomised so that each counts.
NOISY = ("ln1", "ln2", "ln", "final_ln", "gate_norm", "bq", "bk", "bv",
         "A_log", "D", "dt_bias")


def jax_tree(cfg, seed=0):
    """The reference's init_lm weights as numpy, the NOISY leaves
    randomised."""
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'\"")
        if name in NOISY:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return np.array(a)

    return jax.tree_util.tree_map_with_path(
        noisy, init_lm(jax.random.key(seed), cfg))


def batch_of(cfg, B=2, S=16, seed=3):
    return SyntheticTokens(cfg, B, S, seed=seed).next_batch()


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_value_and_grad(cfg, tree, batch):
    fn = jax.value_and_grad(
        lambda p: train_loss(p, cfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree))
    return loss, metrics, jax.tree.map(np.asarray, grads)


def assert_grads_close(got_tree, want_tree):
    """Each leaf within 1e-5 + 1e-4 x its max |grad| (the reference's)."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        tol = 1e-5 + 1e-4 * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_loss_metrics_and_gradients_match_jax(family):
    arch = FAMILIES[family]
    cfg, tcfg = ARCHS[arch].smoke(), T_ARCHS[arch].smoke()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    tree = jax_tree(cfg)
    batch = batch_of(cfg)
    loss, metrics, grads = jax_value_and_grad(cfg, tree, batch)
    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    tloss, tmetrics, tgrads = loss_and_grads(params, tcfg, to_torch(batch))

    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert sorted(tmetrics) == sorted(metrics)
    for k, v in metrics.items():
        if k == "expert_counts":
            np.testing.assert_array_equal(tmetrics[k].numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(float(tmetrics[k]), float(v),
                                       rtol=1e-5, err_msg=k)
    if family == "moe":
        assert float(metrics["dropped_frac"]) > 0      # capacity 1.25 drops
    for g in jax.tree.leaves(params_to_jax(tgrads)):
        assert g.dtype == np.float32
    assert_grads_close(params_to_jax(tgrads), grads)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_remat_policies_give_identical_gradients(family):
    """none / dots / full: the same function, recomputed or saved."""
    arch = FAMILIES[family]
    tcfg = T_ARCHS[arch].smoke()
    tree = jax_tree(ARCHS[arch].smoke())
    batch = to_torch(batch_of(tcfg))
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = params_from_jax(tree, cfg, device="cpu",
                                 dtype=torch.float32)
        loss, _, grads = loss_and_grads(params, cfg, batch)
        out[remat] = (float(loss), jax.tree.leaves(params_to_jax(grads)))
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            np.testing.assert_array_equal(a, b)


def test_unknown_remat_raises():
    cfg = dataclasses.replace(T_ARCHS["tinyllama-1.1b"].smoke(),
                              remat="some")
    params = params_from_jax(jax_tree(ARCHS["tinyllama-1.1b"].smoke()), cfg,
                             device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(params, cfg, to_torch(batch_of(cfg)))


def test_bf16_compute_keeps_float32_masters_and_gradients():
    """Training in bf16: the parameters stay float32 and so do their
    gradients, and the loss is that of the bf16-rounded weights."""
    tcfg = dataclasses.replace(T_ARCHS["tinyllama-1.1b"].smoke(),
                               dtype="bfloat16", remat="full")
    tree = jax_tree(ARCHS["tinyllama-1.1b"].smoke())
    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    batch = to_torch(batch_of(tcfg))
    loss, _, grads = loss_and_grads(params, tcfg, batch)
    for p, g in zip(jax.tree.leaves(params_to_jax(params)),
                    jax.tree.leaves(params_to_jax(grads))):
        assert p.dtype == g.dtype == np.float32
    rounded = params_from_jax(tree, tcfg, device="cpu")      # bf16 matrices
    want, _, _ = loss_and_grads(rounded, tcfg, batch)
    assert float(loss) == float(want)


@pytest.mark.parametrize("oc", [
    dict(lr=1e-3, warmup_steps=5, total_steps=20),
    dict(lr=3e-4, warmup_steps=100, total_steps=10_000, min_lr_frac=0.0),
    dict(lr=2e-3, warmup_steps=0, total_steps=1),
])
def test_cosine_lr_matches_jax(oc):
    for step in (0, 1, 2, 4, 5, 6, 11, 19, 20, 21, 99, 100, 5000, 10_001):
        want = float(cosine_lr(jnp.int32(step), OptConfig(**oc)))
        got = float(t_cosine_lr(torch.tensor(step, dtype=torch.int32),
                                T_OptConfig(**oc)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))


# ------------------------------------------------ the kernels' autograd
def _leaf(rng, *shape, dtype=torch.float32):
    return torch.tensor(rng.normal(size=shape), dtype=dtype,
                        requires_grad=True)


def _kernel_route_grads(plain, args, outs_used):
    """Gradients of sum(out * w) over the used outputs, through plain
    autograd and through KernelFunction with the plain version standing
    in for the launch."""
    res = []
    for route in ("plain", "function"):
        leaves = [a.detach().requires_grad_(a.requires_grad)
                  if torch.is_tensor(a) else a for a in args]
        if route == "plain":
            outs = plain(*leaves)
        else:
            outs = KernelFunction.apply(plain, plain, *leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert all(o.grad_fn is not None for o in outs)
        gen = torch.Generator().manual_seed(0)
        loss = sum((outs[i].float() * torch.randn(outs[i].shape,
                                                  generator=gen)).sum()
                   for i in outs_used)
        wrt = [a for a in leaves if torch.is_tensor(a) and a.requires_grad]
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
        # An input the used outputs do not depend on (C, when only h is
        # used): None from plain autograd, zeros from the Function.
        res.append([torch.zeros_like(a) if g is None else g
                    for g, a in zip(got, wrt)])
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_kernel_function_attention_gradients():
    rng = np.random.default_rng(0)
    q, k, v = _leaf(rng, 2, 12, 4, 16), _leaf(rng, 2, 12, 2, 16), \
        _leaf(rng, 2, 12, 2, 16)
    _kernel_route_grads(attention_ref, (q, k, v, True, None), [0])
    k.requires_grad_(False)                  # only some inputs need grad
    _kernel_route_grads(attention_ref, (q, k, v, True, None), [0])


def test_kernel_function_gmm_gradients_skip_group_sizes():
    rng = np.random.default_rng(1)
    x, w = _leaf(rng, 10, 8), _leaf(rng, 3, 8, 6)
    sizes = torch.tensor([4, 0, 3], dtype=torch.int32)   # rows 7-9: no group
    _kernel_route_grads(gmm_ref, (x, w, sizes), [0])
    out = KernelFunction.apply(gmm_ref, gmm_ref, x, w, sizes)
    dx, dw = torch.autograd.grad(out.sum(), (x, w))
    assert torch.all(dx[7:] == 0) and torch.all(dw[1] == 0)


@pytest.mark.parametrize("used", [[0], [1], [0, 1]])
def test_kernel_function_ssd_gradients_with_or_without_h(used):
    """ssd_chunked returns (y, h); an unused h (None gradient) counts as
    zeros."""
    rng = np.random.default_rng(2)
    Bt, T, H, P, N = 2, 32, 3, 8, 4
    x = _leaf(rng, Bt, T, H, P)
    dt = torch.tensor(rng.uniform(0.01, 0.2, (Bt, T, H)),
                      dtype=torch.float32, requires_grad=True)
    A = torch.tensor(-rng.uniform(0.5, 1.5, H), dtype=torch.float32,
                     requires_grad=True)
    B, C = _leaf(rng, Bt, T, N), _leaf(rng, Bt, T, N)
    _kernel_route_grads(ssd_chunked_ref, (x, dt, A, B, C, 16), used)


def test_needs_grad_only_where_autograd_records():
    t = torch.ones(2, requires_grad=True)
    assert needs_grad(t, torch.ones(2))
    assert not needs_grad(torch.ones(2), 3)
    with torch.no_grad():
        assert not needs_grad(t)
    with torch.inference_mode():
        assert not needs_grad(t)
