"""The port's task bag (``repro_torch.core.taskbag``, P places at once)
against ``repro.core.taskbag`` ``vmap``ped over the same places.

Every operation is compared exactly, dead space included: the clamped
writes and reads near capacity (``dynamic_update_slice`` /
``dynamic_slice`` clamp their offset into [0, C - K]), the ``count > 0``
guard of ``push_block``, and the stable order of ``compact_block``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import taskbag as jtb
from repro_torch.core import taskbag as tb

P, C = 5, 12
JSPEC = {"v": jax.ShapeDtypeStruct((), jnp.int32),
         "w": jax.ShapeDtypeStruct((2,), jnp.float32)}
SPEC = {"v": ((), torch.int32), "w": ((2,), torch.float32)}


def _bags(rng, sizes):
    """The same P bags (random contents, dead space included) for both."""
    v = rng.integers(-100, 100, (P, C)).astype(np.int32)
    w = rng.standard_normal((P, C, 2)).astype(np.float32)
    size = np.asarray(sizes, np.int32)
    jbag = {"items": {"v": jnp.asarray(v), "w": jnp.asarray(w)},
            "size": jnp.asarray(size)}
    bag = {"items": {"v": torch.from_numpy(v.copy()),
                     "w": torch.from_numpy(w.copy())},
           "size": torch.from_numpy(size.copy())}
    return jbag, bag


def _block(rng, k):
    v = rng.integers(-100, 100, (P, k)).astype(np.int32)
    w = rng.standard_normal((P, k, 2)).astype(np.float32)
    return ({"v": jnp.asarray(v), "w": jnp.asarray(w)},
            {"v": torch.from_numpy(v), "w": torch.from_numpy(w)})


def _same(jx, tx):
    """Equal pytrees of jax arrays / torch tensors (dicts nest)."""
    if isinstance(jx, dict):
        assert set(jx) == set(tx)
        for k in jx:
            _same(jx[k], tx[k])
        return
    if isinstance(jx, tuple):
        for a, b in zip(jx, tx, strict=True):
            _same(a, b)
        return
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


SIZES = ([0, 3, 9, 11, 12], [12, 0, 1, 6, 10])


def test_make_bag_and_packet():
    _same(jax.vmap(lambda _: jtb.make_bag(JSPEC, C))(jnp.arange(P)),
          tb.make_bag(SPEC, C, P, "cpu"))
    _same(jax.vmap(lambda _: jtb.make_packet(JSPEC, 4))(jnp.arange(P)),
          tb.make_packet(SPEC, 4, P, "cpu"))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_push_block_clamps_and_guards(sizes, k):
    """Near capacity the write offset clamps to C - K (live rows are
    overwritten, as in JAX); a count of 0 writes nothing."""
    rng = np.random.default_rng(k + sizes[0])
    jbag, bag = _bags(rng, sizes)
    jblk, blk = _block(rng, k)
    count = rng.integers(0, k + 1, P).astype(np.int32)
    count[1] = 0
    _same(jax.vmap(jtb.push_block)(jbag, jblk, jnp.asarray(count)),
          tb.push_block(bag, blk, torch.from_numpy(count)))


@pytest.mark.parametrize("sizes", SIZES)
def test_push_one_peek_pop(sizes):
    rng = np.random.default_rng(1)
    jbag, bag = _bags(rng, sizes)
    jitem, item = _block(rng, 1)
    jitem = {k: v[:, 0] for k, v in jitem.items()}
    item = {k: v[:, 0] for k, v in item.items()}
    jbag = jax.vmap(jtb.push_one)(jbag, jitem)
    bag = tb.push_one(bag, item)
    _same(jbag, bag)
    _same(jax.vmap(jtb.peek_tail)(jbag), tb.peek_tail(bag))
    jout, jpopped = jax.vmap(jtb.pop_tail)(jbag)
    out, popped = tb.pop_tail(bag)
    _same(jpopped, popped)
    _same(jout, out)


def test_pop_tail_mask_keeps_other_places():
    rng = np.random.default_rng(2)
    _, bag = _bags(rng, SIZES[0])
    mask = torch.tensor([True, True, False, True, False])
    bag, _ = tb.pop_tail(bag, mask)
    assert bag["size"].tolist() == [0, 2, 9, 10, 12]


@pytest.mark.parametrize("k", [2, 4, 12])
def test_read_and_write_front(k):
    rng = np.random.default_rng(k)
    jbag, bag = _bags(rng, SIZES[1])
    _same(jax.vmap(lambda b: jtb.read_front(b, k))(jbag),
          tb.read_front(bag, k))
    jblk, blk = _block(rng, k)
    _same(jax.vmap(jtb.write_front)(jbag, jblk), tb.write_front(bag, blk))
    mask = torch.tensor([True, False, True, False, True])
    jbag2, bag2 = _bags(np.random.default_rng(k), SIZES[1])
    want = {key: np.where(mask.numpy().reshape((P,) + (1,) * (v.ndim - 1)),
                          np.asarray(v), np.asarray(jbag2["items"][key]))
            for key, v in jax.vmap(jtb.write_front)(jbag2,
                                                     jblk)["items"].items()}
    got = tb.write_front(bag2, blk, mask)["items"]
    for key in want:
        np.testing.assert_array_equal(want[key], got[key].numpy())


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_split_tail_half_and_merge(sizes, k):
    """k = 8 > C / 2 reaches the clamped read of ``dynamic_slice``."""
    rng = np.random.default_rng(10 + k)
    jbag, bag = _bags(rng, sizes)
    jkept, jpkt = jax.vmap(lambda b: jtb.split_tail_half(b, k))(jbag)
    kept, pkt = tb.split_tail_half(bag, k)
    _same(jpkt, pkt)
    _same(jkept, kept)
    # route every packet one place on and merge (the executor's transfer)
    perm = np.roll(np.arange(P), 1)
    jrecv = jax.tree.map(lambda x: x[perm], jpkt)
    recv = {"items": {key: v[perm] for key, v in pkt["items"].items()},
            "count": pkt["count"][perm]}
    _same(jax.vmap(jtb.merge_packet)(jkept, jrecv),
          tb.merge_packet(kept, recv))


def test_split_tail_half_mask_gives_nothing_elsewhere():
    rng = np.random.default_rng(3)
    _, bag = _bags(rng, SIZES[1])
    mask = torch.tensor([True, False, True, True, False])
    kept, pkt = tb.split_tail_half(bag, 4, mask)
    assert pkt["count"].tolist() == [4, 0, 1, 3, 0]
    assert kept["size"].tolist() == [8, 0, 0, 3, 10]


@pytest.mark.parametrize("seed", range(4))
def test_compact_block_is_stable(seed):
    rng = np.random.default_rng(seed)
    k = 7
    jblk, blk = _block(rng, k)
    valid = rng.random((P, k)) < 0.5
    valid[0] = False
    valid[1] = True
    _same(jax.vmap(jtb.compact_block)(jblk, jnp.asarray(valid)),
          tb.compact_block(blk, torch.from_numpy(valid)))


def test_empty_like_packet():
    rng = np.random.default_rng(4)
    _, bag = _bags(rng, SIZES[1])
    _, pkt = tb.split_tail_half(bag, 3)
    empty = tb.empty_like_packet(pkt)
    assert not empty["count"].any()
    assert all(not v.any() for v in empty["items"].values())
    assert tb.bag_size(bag) is bag["size"]
