"""The port's weights and transformer against the JAX package's.

Both sides run the same parameters (the JAX tree handed over as numpy) on
float32 copies of the tiny configs (tests/conftest.py), with the
reference attention on both sides: on CPU tensors the kernel wrappers run
these same plain versions, and tests/test_torch_kernels.py holds the
kernels themselves on the card.  Logits are held at atol 1e-4 (float32
summed in another order), tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve_torch.models import transformer
from tpuserve_torch.models import weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import kv_cache

ATOL = 1e-4
BS, NB, MB = 4, 32, 8          # block size, blocks, blocks per sequence


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["tiny-qwen3", "tiny-llama", "tiny-opt"])
def test_init_params_equals_jax_init_bitwise(name):
    """The port's init_params draws exactly what the JAX package's does, so
    the card runs the JAX engine's random weights without JAX."""
    cfg = get_model_config(name)
    ours = weights.init_params(cfg, seed=3, device="cpu")
    theirs = weights.params_from_numpy(
        _numpy_tree(jax_weights.init_params(cfg, seed=3)), cfg, "cpu")
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        weights.init_params(get_model_config("tiny-moe"), device="cpu")


class _Pair:
    """One tiny fp32 model on both sides with a paged cache each."""

    def __init__(self, jcfg, cache_dtype="float32"):
        self.jcfg = jcfg
        self.cfg = dataclasses.replace(get_model_config(jcfg.name), dtype="float32")
        jparams = jax_weights.init_params(jcfg, seed=5)
        self.jparams = jparams
        self.params = weights.params_from_numpy(_numpy_tree(jparams), self.cfg, "cpu")
        jcc = jax_kv.CacheConfig(block_size=BS, num_blocks=NB,
                                 max_blocks_per_seq=MB, dtype=cache_dtype)
        cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB,
                                  max_blocks_per_seq=MB, dtype=cache_dtype)
        self.jcache = jax_kv.create_kv_cache(jcfg, jcc)
        self.cache = kv_cache.create_kv_cache(self.cfg, cc, "cpu")
        # two sequences, blocks 0..7 and 8..15
        self.bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)

    def slots(self, b, start, n):
        t = np.arange(start, start + n)
        return (self.bt[b, t // BS] * BS + t % BS).astype(np.int32)


@pytest.fixture(params=["fp32_tiny_qwen3", "fp32_tiny_llama"])
def pair(request):
    return _Pair(request.getfixturevalue(request.param))


def _prefill(p):
    rng = np.random.default_rng(6)
    T = 16
    lens = np.array([16, 11], np.int32)
    tokens = rng.integers(0, p.cfg.vocab_size, (2, T)).astype(np.int32)
    slot_ids = np.full((2, T), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        tokens[b, n:] = 0
        slot_ids[b, :n] = p.slots(b, 0, n)
    jl, p.jcache = jax_tf.prefill(p.jparams, p.jcfg, jnp.asarray(tokens),
                                  jnp.asarray(lens), jnp.asarray(slot_ids),
                                  p.jcache)
    tl, _ = transformer.prefill(p.params, p.cfg, torch.from_numpy(tokens),
                                torch.from_numpy(lens), torch.from_numpy(slot_ids),
                                p.cache, attn_impl="reference")
    return lens, np.asarray(jl), tl.numpy()


def test_prefill_logits_and_cache_match_jax(pair):
    lens, jl, tl = _prefill(pair)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    for li in range(pair.cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(pair.cache[li][key].numpy(),
                                       np.asarray(pair.jcache[li][key]),
                                       atol=ATOL, rtol=0)


def test_decode_step_matches_jax(pair):
    lens, jl, _ = _prefill(pair)
    toks = jl.argmax(-1).astype(np.int32)
    pos = lens.copy()                                    # next position
    slot = np.array([pair.slots(b, int(pos[b]), 1)[0] for b in range(2)], np.int32)
    seq = (lens + 1).astype(np.int32)
    jl2, _ = jax_tf.decode_step(pair.jparams, pair.jcfg, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray(slot),
                                jnp.asarray(pair.bt), jnp.asarray(seq), pair.jcache)
    tl2, _ = transformer.decode_step(pair.params, pair.cfg, torch.from_numpy(toks),
                                     torch.from_numpy(pos), torch.from_numpy(slot),
                                     torch.from_numpy(pair.bt), torch.from_numpy(seq),
                                     pair.cache, attn_impl="reference")
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)


def test_decode_multi_greedy_tokens_match_jax(pair):
    """A fused window: the on-device token chain, the window slots and a
    padding row (inactive, PAD_SLOT writes) all agree with the JAX scan."""
    lens, jl, _ = _prefill(pair)
    B = 4                                                # 2 real rows + 2 padding
    toks = np.zeros(B, np.int32)
    toks[:2] = jl.argmax(-1)
    pos = np.zeros(B, np.int32)
    pos[:2] = lens
    seq = np.ones(B, np.int32)
    seq[:2] = lens + 1
    active = np.array([True, True, False, False])
    bt = np.zeros((B, MB), np.int32)
    bt[:2] = pair.bt
    steps = 6
    jt, _ = jax_tf.decode_multi(
        pair.jparams, pair.jcfg, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(seq), jnp.asarray(active),
        jnp.zeros((B, 2), jnp.uint32), jnp.zeros((B,), jnp.float32),
        pair.jcache, steps=steps, mode="greedy")
    tt, _ = transformer.decode_multi(
        pair.params, pair.cfg, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(bt), torch.from_numpy(seq), torch.from_numpy(active),
        torch.zeros(B), pair.cache, steps=steps, mode="greedy",
        attn_impl="reference")
    assert tt.shape == (B, steps)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])


def test_decode_multi_unported_mode_raises(fp32_tiny_qwen3):
    p = _Pair(fp32_tiny_qwen3)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="full sampler"):
        transformer.decode_multi(p.params, p.cfg, one, one, torch.zeros(1, MB, dtype=torch.int32),
                                 one + 1, torch.ones(1, dtype=torch.bool), torch.ones(1),
                                 p.cache, steps=1, mode="full")


def test_int8_cache_decode_matches_jax(fp32_tiny_qwen3):
    """int8 pages: both sides quantize on write and dequantize on read; the
    tokens of a short greedy window agree."""
    p = _Pair(fp32_tiny_qwen3, cache_dtype="int8")
    lens, jl, tl = _prefill(p)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    B = 2
    toks = jl.argmax(-1).astype(np.int32)
    args = (toks, lens.copy(), p.bt, (lens + 1).astype(np.int32), np.ones(B, bool))
    jt, _ = jax_tf.decode_multi(p.jparams, p.jcfg, *map(jnp.asarray, args),
                                jnp.zeros((B, 2), jnp.uint32), jnp.zeros((B,)),
                                p.jcache, steps=3, mode="greedy")
    tt, _ = transformer.decode_multi(p.params, p.cfg, *map(torch.from_numpy, args),
                                     torch.zeros(B), p.cache, steps=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
