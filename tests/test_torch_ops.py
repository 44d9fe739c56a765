"""The port's plain ops (tpuserve_torch/ops) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides.  The
reference ops are held at atol 5e-5 in float32 (the same math, summed in
another order); the flash and paged plain versions are also held against
the Pallas kernels run in interpret mode, mirroring tests/test_kernels.py.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.ops import attention as jax_attn
from tpuserve.ops import rope as jax_rope
from tpuserve.ops import sampling as jax_sampling
from tpuserve.ops.pallas_flash_attention import flash_prefill_attention as pallas_flash
from tpuserve.ops.pallas_paged_attention import paged_decode_attention as pallas_paged
from tpuserve_torch.models import transformer
from tpuserve_torch.ops import attention, flash_prefill, paged_decode, rope, sampling


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = 5e-5
# one compile per shape instead of one per eager op
_STATIC = ("scale", "sliding_window", "logit_softcap")
jax_prefill = jax.jit(jax_attn.prefill_attention, static_argnames=_STATIC)
jax_paged = jax.jit(jax_attn.paged_decode_attention,
                    static_argnames=_STATIC + ("scale_slices",))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=0)


# ---- rope / norm ----------------------------------------------------------

@pytest.mark.parametrize("scaling", [
    {},
    {"llama3_scaling": (8.0, 1.0, 4.0, 64.0)},
    {"yarn_scaling": (40.0, 32, 1, 0.707, 0.707, 64)},
])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 400, (3, 7)).astype(np.int32)
    x = rng.standard_normal((3, 7, 4, 32)).astype(np.float32)
    jc, js = jax_rope.rope_freqs(jnp.asarray(pos), 32, 1e4, 24, **scaling)
    tc, ts = rope.rope_freqs(_t(pos), 32, 1e4, 24, **scaling)
    _close(tc, jc)
    _close(ts, js)
    _close(rope.apply_rope(_t(x), tc, ts), jax_rope.apply_rope(jnp.asarray(x), jc, js))


def test_yarn_mscale_matches_jax():
    for s, m in ((40.0, 0.707), (1.0, 1.0), (4.0, 1.0)):
        assert rope.yarn_mscale(s, m) == jax_rope.yarn_mscale(s, m)


def test_rmsnorm_and_layernorm_match_jax():
    from tpuserve.models import transformer as jax_tf
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    _close(transformer.rmsnorm(_t(x), _t(w), 1e-6, 1.0),
           jax_tf.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6, 1.0))
    _close(transformer.layernorm(_t(x), _t(w), _t(b), 1e-5),
           jax_tf.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))


# ---- KV cache writes ----------------------------------------------------

def _slots(rng, shape, num_slots, pad_every=3):
    slots = rng.permutation(num_slots)[:int(np.prod(shape))].reshape(shape)
    slots = slots.astype(np.int32)
    slots.reshape(-1)[::pad_every] = attention.PAD_SLOT
    return slots


def test_write_kv_cache_drops_pad_slot():
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((8, 4, 2, 16)).astype(np.float32)
    new = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    slots = _slots(rng, (2, 5), 32)
    ref = jax_attn.write_kv_cache(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(slots))
    got = _t(cache.copy())
    attention.write_kv_cache(got, _t(new), _t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_write_kv_entry_int8_matches_jax():
    rng = np.random.default_rng(4)
    shape = (8, 4, 2, 16)
    k = rng.standard_normal((6, 2, 16)).astype(np.float32)
    v = rng.standard_normal((6, 2, 16)).astype(np.float32)
    slots = _slots(rng, (6,), 32)
    jentry = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
              "ks": jnp.zeros(shape[:3], jnp.float32),
              "vs": jnp.zeros(shape[:3], jnp.float32)}
    ref = jax_attn.write_kv_entry(jentry, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(slots))
    tentry = {"k": torch.zeros(shape, dtype=torch.int8),
              "v": torch.zeros(shape, dtype=torch.int8),
              "ks": torch.zeros(shape[:3]), "vs": torch.zeros(shape[:3])}
    attention.write_kv_entry(tentry, _t(k), _t(v), _t(slots))
    for key in ("k", "v"):
        np.testing.assert_array_equal(tentry[key].numpy(), np.asarray(ref[key]))
    for key in ("ks", "vs"):
        _close(tentry[key], ref[key], atol=1e-7)


# ---- prefill attention --------------------------------------------------

PREFILL_CASES = [
    dict(B=2, T=64, Hq=4, Hkv=2, D=16),
    dict(B=1, T=128, Hq=8, Hkv=8, D=64),
    dict(B=2, T=48, Hq=4, Hkv=4, D=32),
    dict(B=2, T=40, Hq=4, Hkv=2, D=16, window=8, softcap=30.0),
    dict(B=2, T=40, Hq=8, Hkv=8, D=96),                    # Phi-3's head_dim
    dict(B=2, T=36, Hq=4, Hkv=2, D=96, window=8),
]


def _prefill_inputs(c, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c["B"], c["T"], c["Hq"], c["D"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["T"], c["Hkv"], c["D"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["T"], c["Hkv"], c["D"])).astype(np.float32)
    lens = rng.integers(1, c["T"] + 1, (c["B"],)).astype(np.int32)
    lens[0] = c["T"]
    return q, k, v, lens


@pytest.mark.parametrize("c", PREFILL_CASES)
def test_prefill_attention_matches_jax_reference(c):
    q, k, v, lens = _prefill_inputs(c, c["T"])
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    ref = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lens), c["D"] ** -0.5, **kw)
    out = attention.prefill_attention(_t(q), _t(k), _t(v), _t(lens),
                                      c["D"] ** -0.5, **kw)
    for b, n in enumerate(lens):            # rows past the prompt are unspecified
        _close(out[b, :n], np.asarray(ref)[b, :n])


@pytest.mark.parametrize("c", PREFILL_CASES)
def test_prefill_plain_matches_pallas_interpret(c):
    q, k, v, lens = _prefill_inputs(c, c["T"] + 1)
    # padding keys hold NaN: both sides must zero V there
    for b, n in enumerate(lens):
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    ref = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lens), c["D"] ** -0.5, blk_q=32, blk_k=32,
                       interpret=True, **kw)
    out = flash_prefill.flash_prefill_attention(_t(q), _t(k), _t(v), _t(lens),
                                                c["D"] ** -0.5, **kw)
    for b, n in enumerate(lens):
        _close(out[b, :n], np.asarray(ref)[b, :n])


# ---- paged decode attention ---------------------------------------------

PAGED_CASES = [
    dict(B=2, Hq=4, Hkv=2, D=16, page=4, nb=16, mp=4),
    dict(B=3, Hq=8, Hkv=8, D=64, page=16, nb=32, mp=8),
    dict(B=1, Hq=16, Hkv=2, D=128, page=32, nb=64, mp=4),
    dict(B=5, Hq=4, Hkv=2, D=128, page=8, nb=64, mp=8, int8=True),
    dict(B=3, Hq=4, Hkv=2, D=32, page=4, nb=32, mp=8, window=10),
    dict(B=3, Hq=4, Hkv=2, D=32, page=4, nb=32, mp=8, softcap=20.0),
    dict(B=3, Hq=8, Hkv=8, D=96, page=8, nb=32, mp=4),      # Phi-3's head_dim
    dict(B=3, Hq=4, Hkv=2, D=96, page=4, nb=32, mp=8, int8=True, window=9),
    dict(B=4, Hq=4, Hkv=2, D=32, page=4, nb=64, mp=8, int8=True, window=7,
         softcap=20.0),
]


def _paged_inputs(c, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c["B"], c["Hq"], c["D"])).astype(np.float32)
    kc = rng.standard_normal((c["nb"], c["page"], c["Hkv"], c["D"])).astype(np.float32)
    vc = rng.standard_normal((c["nb"], c["page"], c["Hkv"], c["D"])).astype(np.float32)
    bt = rng.permutation(c["nb"])[:c["B"] * c["mp"]].reshape(c["B"], c["mp"])
    sl = rng.integers(1, c["page"] * c["mp"] + 1, (c["B"],)).astype(np.int32)
    sl[0] = c["page"] * c["mp"]
    return q, kc, vc, bt.astype(np.int32), sl


def _quantized(c, kc, vc):
    if not c.get("int8"):
        return kc, vc, None, None
    kq, ks = jax_attn.quantize_kv(jnp.asarray(kc))
    vq, vs = jax_attn.quantize_kv(jnp.asarray(vc))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


def _paged_kw(c, ks, vs, conv):
    return dict(k_scale=None if ks is None else conv(ks),
                v_scale=None if vs is None else conv(vs),
                sliding_window=c.get("window"), logit_softcap=c.get("softcap"))


@pytest.mark.parametrize("c", PAGED_CASES)
def test_paged_decode_matches_jax_reference(c):
    q, kc, vc, bt, sl = _paged_inputs(c, c["B"] + c["Hq"])
    kc, vc, ks, vs = _quantized(c, kc, vc)
    ref = jax_paged(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(sl), c["D"] ** -0.5, **_paged_kw(c, ks, vs, jnp.asarray))
    out = attention.paged_decode_attention(
        _t(q), _t(kc), _t(vc), _t(bt), _t(sl), c["D"] ** -0.5,
        **_paged_kw(c, ks, vs, _t))
    _close(out, ref)


@pytest.mark.parametrize("c", PAGED_CASES)
def test_paged_decode_plain_matches_pallas_interpret(c):
    q, kc, vc, bt, sl = _paged_inputs(c, c["B"] * 7)
    kc, vc, ks, vs = _quantized(c, kc, vc)
    ref = pallas_paged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray(bt), jnp.asarray(sl), c["D"] ** -0.5,
                       interpret=True, pages_per_group=2, seqs_per_program=2,
                       **_paged_kw(c, ks, vs, jnp.asarray))
    out = paged_decode.paged_decode_attention(
        _t(q), _t(kc), _t(vc), _t(bt), _t(sl), c["D"] ** -0.5,
        **_paged_kw(c, ks, vs, _t))
    _close(out, ref)


def test_paged_decode_nan_seeded_cache_matches_pallas():
    """Slots past each sequence (and before its window) hold NaN, as a
    fresh ``torch.empty`` cache may: the plain version, like the Pallas
    kernel, must keep them out of the output."""
    c = dict(B=3, Hq=4, Hkv=2, D=32, page=4, nb=32, mp=8, window=9)
    q, kc, vc, bt, sl = _paged_inputs(c, 11)
    sl[:] = [32, 13, 5]
    for b, n in enumerate(sl):
        for t in list(range(n, 32)) + list(range(0, max(n - 9, 0))):
            kc[bt[b, t // 4], t % 4] = np.nan
            vc[bt[b, t // 4], t % 4] = np.nan
    ref = pallas_paged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray(bt), jnp.asarray(sl), c["D"] ** -0.5,
                       interpret=True, sliding_window=9)
    out = attention.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(sl),
                                           c["D"] ** -0.5, sliding_window=9)
    assert torch.isfinite(out).all()
    _close(out, ref)


def test_paged_decode_zero_length_row_is_zero():
    c = dict(B=2, Hq=4, Hkv=2, D=16, page=4, nb=16, mp=4)
    q, kc, vc, bt, sl = _paged_inputs(c, 12)
    sl[1] = 0
    out = attention.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(sl),
                                           0.25)
    assert torch.count_nonzero(out[1]) == 0


# ---- sampling -------------------------------------------------------------

def test_sample_greedy_matches_jax_exactly():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    B = logits.shape[0]
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.zeros((B, 2), jnp.uint32), jnp.zeros((B,)),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,)), mode="greedy")
    out = sampling.sample_tokens(_t(logits), mode="greedy")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_temperature_matches_jax_with_same_noise():
    rng = np.random.default_rng(6)
    B, V = 8, 300
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    temp = np.array([0.7, 1.0, 0.0, 1.3, 0.5, 2.0, 0.0, 0.9], np.float32)
    keys = rng.integers(0, 2**31, (B, 2)).astype(np.uint32)
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,)), mode="temperature")
    noise = np.asarray(jax_sampling._row_gumbel(jnp.asarray(keys), (B, V)))
    out = sampling.sample_tokens(_t(logits), _t(temp), mode="temperature",
                                 gumbel=_t(noise))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gumbel_noise_per_row_generators():
    """Each row's noise comes from its own (salt, step) key, not from a
    generator object: rows with one key are equal, other keys differ."""
    salt = torch.tensor([7, 8, 7, 7], dtype=torch.int32)
    step = torch.tensor([3, 3, 3, 4], dtype=torch.int32)
    noise = sampling.keyed_gumbel(salt, step, 50)
    assert noise.shape == (4, 50)
    assert torch.equal(noise[0], noise[2])
    assert not torch.equal(noise[0], noise[1]) and not torch.equal(noise[0], noise[3])
    assert torch.isfinite(noise).all()


# ---- the CUDA wrappers ----------------------------------------------------

def test_wrappers_use_plain_version_on_cpu_without_launching():
    c = PREFILL_CASES[0]
    q, k, v, lens = _prefill_inputs(c, 9)
    n0 = flash_prefill.LAUNCHES
    out = flash_prefill.flash_prefill_attention(_t(q), _t(k), _t(v), _t(lens), 0.25)
    ref = attention.prefill_attention(_t(q), _t(k), _t(v), _t(lens), 0.25)
    assert torch.equal(out, ref) and flash_prefill.LAUNCHES == n0
    c = PAGED_CASES[0]
    q, kc, vc, bt, sl = _paged_inputs(c, 10)
    n0 = paged_decode.LAUNCHES
    out = paged_decode.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(sl), 0.25)
    ref = attention.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(sl), 0.25)
    assert torch.equal(out, ref) and paged_decode.LAUNCHES == n0

