"""The port's ``SyntheticTokens`` against the JAX package's, bit for bit:
every family's batch layout (tokens, audio codebook streams, vlm
embeddings / positions / labels), a resume mid-stream from the saved
``DataState``, and ``shard``."""
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.data.pipeline import DataState, SyntheticTokens
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.data.pipeline import DataState as T_DataState
from repro_torch.data.pipeline import SyntheticTokens as T_SyntheticTokens

ARCH_NAMES = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "mamba2-130m",
              "zamba2-7b", "qwen2-vl-2b", "musicgen-medium"]


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("preset", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batches_are_bit_exact(arch, preset):
    cfg, tcfg = ARCHS[arch], T_ARCHS[arch]
    if preset == "smoke":
        cfg, tcfg = cfg.smoke(), tcfg.smoke()
    S = 32 if preset == "smoke" else 128
    ref = SyntheticTokens(cfg, 4, S, seed=7)
    port = T_SyntheticTokens(tcfg, 4, S, seed=7)
    for _ in range(3):
        _equal(port.next_batch(), ref.next_batch())
    assert port.state.to_dict() == ref.state.to_dict() == {"seed": 7,
                                                           "step": 3}


def test_resume_mid_stream_replays_the_same_batches():
    cfg, tcfg = ARCHS["tinyllama-1.1b"].smoke(), T_ARCHS[
        "tinyllama-1.1b"].smoke()
    ref = SyntheticTokens(cfg, 8, 64, seed=3)
    for _ in range(5):
        ref.next_batch()
    saved = ref.state.to_dict()
    want = [ref.next_batch() for _ in range(3)]
    port = T_SyntheticTokens(tcfg, 8, 64, seed=99)
    port.state = T_DataState.from_dict(saved)
    for w in want:
        _equal(port.next_batch(), w)
    assert DataState.from_dict(port.state.to_dict()) == ref.state


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_slices_the_global_batch(world):
    cfg, tcfg = ARCHS["qwen2-vl-2b"].smoke(), T_ARCHS["qwen2-vl-2b"].smoke()
    ref = SyntheticTokens(cfg, 8, 16, seed=1)
    port = T_SyntheticTokens(tcfg, 8, 16, seed=1)
    rb, pb = ref.next_batch(), port.next_batch()
    for rank in range(world):
        _equal(port.shard(pb, rank, world), ref.shard(rb, rank, world))
    parts = [port.shard(pb, r, world)["labels"] for r in range(world)]
    np.testing.assert_array_equal(np.concatenate(parts), pb["labels"])
