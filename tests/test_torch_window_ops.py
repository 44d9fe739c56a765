"""The port's plain window and ragged attention ops against the JAX
package's: ``chunked_prefill_attention``, ``ragged_attention``,
``ragged_blocked_attention`` and the ragged kernel's plain contract
(``attention.ragged_paged_attention``).

Inputs are made with numpy from a seed and handed to both sides.  Each op
is held at atol 1e-4 in float32 against the JAX reference, and against the
Pallas kernels run in interpret mode (``paged_window_attention`` and
``ragged_paged_attention`` with ``blk_q=8``), mirroring
tests/test_kernels.py.  Rows past ``chunk_lens`` / ``q_lens`` and padding
rows are unspecified by contract and excluded.  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.ops import attention as jax_attn
from tpuserve.ops.pallas_chunked_prefill import paged_window_attention as pallas_window
from tpuserve.ops.pallas_ragged_attention import ragged_paged_attention as pallas_ragged
from tpuserve_torch.ops import attention, paged_window, ragged_paged


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
_STATIC = ("scale", "sliding_window", "logit_softcap")
jax_chunked = jax.jit(jax_attn.chunked_prefill_attention,
                      static_argnames=_STATIC + ("seg_size",))
jax_ragged = jax.jit(jax_attn.ragged_attention, static_argnames=_STATIC + ("seg_size",))
jax_blocked = jax.jit(jax_attn.ragged_blocked_attention,
                      static_argnames=_STATIC + ("blk",))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=0)


def _quantize(kc, vc):
    kq, ks = jax_attn.quantize_kv(jnp.asarray(kc))
    vq, vs = jax_attn.quantize_kv(jnp.asarray(vc))
    return tuple(np.asarray(x) for x in (kq, vq, ks, vs))


# ---- chunked prefill (paged window) ---------------------------------------

# B, C, Hq, Hkv, D, page, nb, mp, max_ctx, blk_q (tests/test_kernels.py:244-248),
# then int8 (:115), sliding windows (:365) and softcap
WINDOW_CASES = [
    dict(B=2, C=16, Hq=4, Hkv=2, D=16, page=4, nb=24, mp=8, max_ctx=12, blk_q=8),
    dict(B=1, C=32, Hq=8, Hkv=8, D=64, page=16, nb=16, mp=8, max_ctx=90, blk_q=16),
    dict(B=3, C=8, Hq=16, Hkv=2, D=128, page=32, nb=16, mp=4, max_ctx=50, blk_q=8),
    dict(B=2, C=16, Hq=4, Hkv=2, D=128, page=8, nb=64, mp=8, ctx=[9, 0], int8=True, blk_q=8),
    dict(B=2, C=8, Hq=4, Hkv=2, D=128, page=4, nb=128, mp=24, ctx=[60, 0], window=6, blk_q=4),
    dict(B=2, C=8, Hq=4, Hkv=2, D=128, page=4, nb=128, mp=24, ctx=[60, 0], window=20, blk_q=4),
    dict(B=2, C=16, Hq=4, Hkv=2, D=32, page=4, nb=32, mp=12, ctx=[20, 3], softcap=20.0, blk_q=8),
    dict(B=2, C=16, Hq=8, Hkv=8, D=96, page=8, nb=32, mp=8, ctx=[21, 0], blk_q=8),   # Phi-3
    dict(B=2, C=8, Hq=4, Hkv=2, D=96, page=4, nb=64, mp=16, ctx=[30, 2], window=9, int8=True,
         blk_q=4),
]


def _window_inputs(c, seed):
    """Random cache + a written window at ctx_lens .. ctx_lens + chunk_lens,
    with disjoint block tables (the recipe of tests/test_kernels.py:224)."""
    rng = np.random.default_rng(seed)
    B, C, mp, page = c["B"], c["C"], c["mp"], c["page"]
    q = rng.standard_normal((B, C, c["Hq"], c["D"])).astype(np.float32)
    shape = (c["nb"], page, c["Hkv"], c["D"])
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    bt = np.stack([np.arange(b * mp, (b + 1) * mp) % c["nb"] for b in range(B)])
    chunk = rng.integers(1, C + 1, (B,)).astype(np.int32)
    if "ctx" in c:
        ctx = np.asarray(c["ctx"], np.int32)
        chunk[:] = C
        chunk[-1] = C - 3
    else:
        ctx = rng.integers(0, c["max_ctx"] + 1, (B,)).astype(np.int32)
    ctx = np.minimum(ctx, mp * page - chunk).astype(np.int32)
    ks = vs = None
    if c.get("int8"):
        kc, vc, ks, vs = _quantize(kc, vc)
    return q, kc, vc, bt.astype(np.int32), ctx, chunk, ks, vs


def _window_kw(c, ks, vs, conv):
    return dict(k_scale=None if ks is None else conv(ks),
                v_scale=None if vs is None else conv(vs),
                sliding_window=c.get("window"), logit_softcap=c.get("softcap"))


def _valid_rows(out, ref, chunk):
    for b, n in enumerate(chunk):          # rows past chunk_lens are unspecified
        _close(np.asarray(out)[b, :n], np.asarray(ref)[b, :n])


@pytest.mark.parametrize("c", WINDOW_CASES)
def test_chunked_prefill_attention_matches_jax_reference(c):
    q, kc, vc, bt, ctx, chunk, ks, vs = _window_inputs(c, c["C"] + c["Hq"])
    scale = c["D"] ** -0.5
    ref = jax_chunked(*map(jnp.asarray, (q, kc, vc, bt, ctx, chunk)), scale,
                      **_window_kw(c, ks, vs, jnp.asarray))
    out = attention.chunked_prefill_attention(*map(_t, (q, kc, vc, bt, ctx, chunk)),
                                              scale, **_window_kw(c, ks, vs, _t))
    _valid_rows(out, ref, chunk)


@pytest.mark.parametrize("c", WINDOW_CASES)
def test_chunked_plain_matches_pallas_interpret(c):
    q, kc, vc, bt, ctx, chunk, ks, vs = _window_inputs(c, c["C"] * 3 + 1)
    scale = c["D"] ** -0.5
    ref = pallas_window(*map(jnp.asarray, (q, kc, vc, bt, ctx, chunk)), scale,
                        interpret=True, blk_q=c["blk_q"], pages_per_group=2,
                        **_window_kw(c, ks, vs, jnp.asarray))
    out = paged_window.paged_window_attention(*map(_t, (q, kc, vc, bt, ctx, chunk)),
                                              scale, **_window_kw(c, ks, vs, _t))
    _valid_rows(out, ref, chunk)


def test_chunked_zero_context_and_rows_past_the_chunk():
    """A prompt's first chunk (ctx 0) is pure causal attention within the
    window (tests/test_kernels.py:264); rows past chunk_lens return 0."""
    c = dict(B=2, C=16, Hq=4, Hkv=2, D=32, page=4, nb=16, mp=8, max_ctx=0)
    q, kc, vc, bt, ctx, chunk, _, _ = _window_inputs(c, 7)
    ctx[:] = 0
    chunk[:] = [16, 5]
    ref = pallas_window(*map(jnp.asarray, (q, kc, vc, bt, ctx, chunk)), 32 ** -0.5,
                        interpret=True, blk_q=8)
    out = attention.chunked_prefill_attention(*map(_t, (q, kc, vc, bt, ctx, chunk)),
                                              32 ** -0.5)
    _valid_rows(out, ref, chunk)
    assert torch.count_nonzero(out[1, 5:]) == 0


def test_chunked_multi_segment_context():
    """A context that spans several key segments of the plain version and
    several page groups of the Pallas kernel (tests/test_kernels.py:279)."""
    c = dict(B=1, C=8, Hq=4, Hkv=2, D=32, page=4, nb=64, mp=32, max_ctx=100)
    q, kc, vc, bt, ctx, chunk, _, _ = _window_inputs(c, 11)
    ctx[:], chunk[:] = 100, 8
    ref = pallas_window(*map(jnp.asarray, (q, kc, vc, bt, ctx, chunk)), 32 ** -0.5,
                        interpret=True, blk_q=8, pages_per_group=3)
    out = attention.chunked_prefill_attention(*map(_t, (q, kc, vc, bt, ctx, chunk)),
                                              32 ** -0.5, seg_size=16)
    _valid_rows(out, ref, chunk)


@pytest.mark.parametrize("window", [None, 7])
def test_chunked_nan_seeded_cache_matches_pallas(window):
    """Slots past each window's written keys, and before its first row's
    sliding window, hold NaN as a fresh ``torch.empty`` cache may: the
    plain version, like the Pallas kernel, keeps them out of the output."""
    c = dict(B=2, C=8, Hq=4, Hkv=2, D=32, page=4, nb=32, mp=8, ctx=[17, 0],
             window=window)
    q, kc, vc, bt, ctx, chunk, _, _ = _window_inputs(c, 13)
    for b in range(2):
        total = int(ctx[b] + chunk[b])
        dead = list(range(total, 32))
        if window:
            dead += list(range(0, max(int(ctx[b]) - window + 1, 0)))
        for t in dead:
            kc[bt[b, t // 4], t % 4] = np.nan
            vc[bt[b, t // 4], t % 4] = np.nan
    kw = dict(sliding_window=window)
    ref = pallas_window(*map(jnp.asarray, (q, kc, vc, bt, ctx, chunk)), 32 ** -0.5,
                        interpret=True, blk_q=4, pages_per_group=2, **kw)
    out = attention.chunked_prefill_attention(*map(_t, (q, kc, vc, bt, ctx, chunk)),
                                              32 ** -0.5, **kw)
    assert torch.isfinite(out).all()
    _valid_rows(out, ref, chunk)


def test_chunked_mla_scale_slices_raise():
    """Per-slice int8 scales (MLA's latent and rope slices) are ported: a
    one-head int8 latent cache read as K and V equals the JAX op's."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    cache = rng.integers(-127, 128, (4, 4, 1, 16)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (4, 4, 2)).astype(np.float32)
    bt = np.array([[0, 1], [2, 3]], np.int32)
    ctx, chunk = np.array([2, 0], np.int32), np.array([3, 2], np.int32)
    args = (q, cache, cache, bt, ctx, chunk)
    out = attention.chunked_prefill_attention(*map(_t, args), 0.25, k_scale=_t(scales),
                                              v_scale=_t(scales), scale_slices=(8, 8))
    ref = jax_attn.chunked_prefill_attention(*map(jnp.asarray, args), 0.25,
                                             k_scale=jnp.asarray(scales),
                                             v_scale=jnp.asarray(scales), scale_slices=(8, 8))
    for b in range(2):
        np.testing.assert_allclose(out.numpy()[b, :chunk[b]], np.asarray(ref)[b, :chunk[b]],
                                   atol=1e-5, rtol=1e-5)


# ---- ragged mixed layout ---------------------------------------------------

def _ragged_case(seed, n_dec, chunk_shapes, blk, Hq=4, Hkv=2, D=16, page=4,
                 nb=64, mp=8, int8=False, max_kv=None):
    """A mixed flat layout (decode rows first, blk-aligned prefill chunks)
    and its descriptors, packed as the engine's _run_mixed packs them (the
    recipe of tests/test_kernels.py:394).  ``chunk_shapes``: (q_len, kv_len)
    per chunk.  Returns numpy arrays and the valid-row mask."""
    rng = np.random.default_rng(seed)
    max_kv = max_kv or page * mp
    kc = rng.standard_normal((nb, page, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((nb, page, Hkv, D)).astype(np.float32)
    ks = vs = None
    if int8:
        kc, vc, ks, vs = _quantize(kc, vc)
    kv_dec = rng.integers(1, max_kv + 1, size=n_dec)
    B = max(n_dec + len(chunk_shapes), 1)
    cursor = -(-n_dec // blk) * blk
    starts = []
    for ql, _ in chunk_shapes:
        starts.append(cursor)
        cursor += -(-ql // blk) * blk
    T = max(-(-max(cursor, 1) // blk) * blk, blk)
    bt = rng.integers(0, nb, (B, mp)).astype(np.int32)
    kv_lens = np.zeros((B,), np.int32)
    q_starts = np.full((B,), T, np.int32)
    q_lens = np.zeros((B,), np.int32)
    row_seq = np.zeros((T,), np.int32)
    row_pos = np.zeros((T,), np.int32)
    valid = np.zeros((T,), bool)
    for i in range(n_dec):
        kv_lens[i], q_starts[i], q_lens[i] = kv_dec[i], i, 1
        row_seq[i], row_pos[i], valid[i] = i, kv_dec[i] - 1, True
    blk_seq = np.full((T // blk,), -1, np.int32)
    for si, ((ql, kl), st) in enumerate(zip(chunk_shapes, starts), start=n_dec):
        kv_lens[si], q_starts[si], q_lens[si] = kl, st, ql
        row_seq[st:st + ql] = si
        row_pos[st:st + ql] = kl - ql + np.arange(ql)
        valid[st:st + ql] = True
        blk_seq[st // blk:(st + -(-ql // blk) * blk) // blk] = si
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    meta = np.asarray([n_dec, -(-n_dec // blk)], np.int32)
    return dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=bt, kv_lens=kv_lens,
                q_starts=q_starts, q_lens=q_lens, meta=meta, blk_seq=blk_seq,
                row_seq=row_seq, row_pos=row_pos, valid=valid, blk=blk,
                scale=D ** -0.5)


def _descriptors(c, conv):
    return [conv(c[k]) for k in ("q", "kc", "vc", "bt", "kv_lens", "q_starts",
                                 "q_lens", "meta", "blk_seq")]


def _scales(c, conv, **kw):
    return dict(k_scale=None if c["ks"] is None else conv(c["ks"]),
                v_scale=None if c["vs"] is None else conv(c["vs"]), **kw)


# n_dec, (q_len, kv_len) chunks, blk (tests/test_kernels.py:470-475, 510-541)
RAGGED_CASES = [
    dict(n_dec=3, chunks=[(5, 9), (12, 12)], blk=8),
    dict(n_dec=8, chunks=[], blk=4),
    dict(n_dec=0, chunks=[(13, 20)], blk=8),
    dict(n_dec=5, chunks=[(7, 7)], blk=4),
    dict(n_dec=4, chunks=[(10, 26)], blk=8),
    dict(n_dec=3, chunks=[(6, 11)], blk=8, D=128, page=8, int8=True),
    dict(n_dec=4, chunks=[(7, 25)], blk=8, mp=12, max_kv=40, window=5),
    dict(n_dec=4, chunks=[(7, 25)], blk=8, mp=12, max_kv=40, window=16, softcap=20.0),
    dict(n_dec=3, chunks=[(6, 11)], blk=8, D=96, page=8),               # Phi-3's head_dim
]


def _case(c, seed):
    kw = {k: c[k] for k in ("D", "page", "mp", "int8", "max_kv") if k in c}
    return _ragged_case(seed, c["n_dec"], c["chunks"], c["blk"], **kw)


@pytest.mark.parametrize("c", RAGGED_CASES)
def test_ragged_attention_matches_jax_reference(c):
    r = _case(c, c["n_dec"] * 31 + len(c["chunks"]))
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    row_bt = r["bt"][np.clip(r["row_seq"], 0, r["bt"].shape[0] - 1)]
    ref = jax_ragged(jnp.asarray(r["q"]), jnp.asarray(r["kc"]), jnp.asarray(r["vc"]),
                     jnp.asarray(row_bt), jnp.asarray(r["row_pos"] + 1), r["scale"],
                     seg_size=8, **_scales(r, jnp.asarray, **kw))
    out = attention.ragged_attention(_t(r["q"]), _t(r["kc"]), _t(r["vc"]), _t(row_bt),
                                     _t(r["row_pos"] + 1), r["scale"], seg_size=8,
                                     **_scales(r, _t, **kw))
    _close(out.numpy()[r["valid"]], np.asarray(ref)[r["valid"]])


@pytest.mark.parametrize("c", [c for c in RAGGED_CASES if c["chunks"]])
def test_ragged_blocked_attention_matches_jax_reference(c):
    """The block-gather path on the prefill blocks (the rows it is valid
    for)."""
    r = _case(c, c["n_dec"] * 17 + 5)
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    blk_bt = r["bt"][np.clip(r["blk_seq"], 0, None)]
    lens = r["row_pos"] + 1
    ref = jax_blocked(jnp.asarray(r["q"]), jnp.asarray(r["kc"]), jnp.asarray(r["vc"]),
                      jnp.asarray(blk_bt), jnp.asarray(lens), blk=r["blk"],
                      scale=r["scale"], **_scales(r, jnp.asarray, **kw))
    out = attention.ragged_blocked_attention(
        _t(r["q"]), _t(r["kc"]), _t(r["vc"]), _t(blk_bt), _t(lens), r["blk"],
        r["scale"], **_scales(r, _t, **kw))
    rows = r["valid"] & (np.arange(len(lens)) >= r["meta"][1] * r["blk"])
    _close(out.numpy()[rows], np.asarray(ref)[rows])


@pytest.mark.parametrize("c", RAGGED_CASES)
def test_ragged_plain_matches_pallas_interpret(c):
    """The kernel contract's plain version (descriptors in, no host
    row data) against the Pallas ragged kernel at blk_q=8 or 4."""
    r = _case(c, c["n_dec"] * 7 + 3)
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    ref = pallas_ragged(*_descriptors(r, jnp.asarray), r["scale"], interpret=True,
                        blk_q=r["blk"], pages_per_group=2,
                        **_scales(r, jnp.asarray, **kw))
    out = ragged_paged.ragged_paged_attention(*_descriptors(r, _t), r["scale"], r["blk"],
                                              **_scales(r, _t, **kw))
    _close(out.numpy()[r["valid"]], np.asarray(ref)[r["valid"]])


def test_ragged_rows_from_descriptors():
    """ragged_rows recovers each row's sequence and length from the
    descriptors alone; rows that serve no query get length 0."""
    r = _ragged_case(3, 3, [(5, 9), (12, 12)], 8)
    seq, lens = attention.ragged_rows(*(_t(r[k]) for k in (
        "kv_lens", "q_starts", "q_lens", "meta", "blk_seq")), r["blk"])
    v = r["valid"]
    np.testing.assert_array_equal(seq.numpy()[v], r["row_seq"][v])
    np.testing.assert_array_equal(lens.numpy()[v], r["row_pos"][v] + 1)
    assert (lens.numpy()[~v] == 0).all()


def test_ragged_nan_seeded_cache_matches_pallas():
    """Unwritten slots past each sequence's kv_len hold NaN: the plain
    version keeps them out of every valid row, as the Pallas kernel does."""
    r = _ragged_case(23, 3, [(6, 14), (9, 9)], 8, nb=64, mp=8)
    r["bt"] = np.arange(r["bt"].size, dtype=np.int32).reshape(r["bt"].shape) % 64
    for s, n in enumerate(r["kv_lens"]):
        for t in range(int(n), 32):
            r["kc"][r["bt"][s, t // 4], t % 4] = np.nan
            r["vc"][r["bt"][s, t // 4], t % 4] = np.nan
    ref = pallas_ragged(*_descriptors(r, jnp.asarray), r["scale"], interpret=True,
                        blk_q=8, pages_per_group=2)
    out = ragged_paged.ragged_paged_attention(*_descriptors(r, _t), r["scale"], 8)
    assert torch.isfinite(out[torch.from_numpy(r["valid"])]).all()
    _close(out.numpy()[r["valid"]], np.asarray(ref)[r["valid"]])


def test_ragged_decode_rows_are_the_phase_split_decode_math():
    """Decode rows of the plain ragged contract equal the plain paged
    decode over the same rows exactly (the mixed/phase-split token
    identity contract); chunk rows equal the plain window attention."""
    r = _ragged_case(77, 3, [(6, 14), (9, 9)], 8)
    out = ragged_paged.ragged_paged_attention(*_descriptors(r, _t), r["scale"], 8)
    dec = attention.paged_decode_attention(_t(r["q"][:3]), _t(r["kc"]), _t(r["vc"]),
                                           _t(r["bt"][:3]), _t(r["kv_lens"][:3]),
                                           r["scale"])
    assert torch.equal(out[:3], dec)
    for si, (ql, kl) in enumerate([(6, 14), (9, 9)], start=3):
        st = int(r["q_starts"][si])
        win = attention.chunked_prefill_attention(
            _t(r["q"][None, st:st + ql]), _t(r["kc"]), _t(r["vc"]), _t(r["bt"][si:si + 1]),
            torch.tensor([kl - ql], dtype=torch.int32), torch.tensor([ql], dtype=torch.int32),
            r["scale"])
        _close(out[st:st + ql], win[0])


# ---- the wrappers on CPU tensors and the block size ------------------------

def test_new_wrappers_use_plain_version_on_cpu_without_launching():
    c = WINDOW_CASES[0]
    q, kc, vc, bt, ctx, chunk, _, _ = _window_inputs(c, 3)
    args = [_t(x) for x in (q, kc, vc, bt, ctx, chunk)]
    n0 = paged_window.LAUNCHES
    out = paged_window.paged_window_attention(*args, 0.25)
    assert torch.equal(out, attention.chunked_prefill_attention(*args, 0.25))
    assert paged_window.LAUNCHES == n0
    r = _ragged_case(5, 3, [(5, 9)], 8)
    n0 = ragged_paged.LAUNCHES
    out = ragged_paged.ragged_paged_attention(*_descriptors(r, _t), 0.25, 8)
    ref = attention.ragged_paged_attention(*_descriptors(r, _t), 0.25, 8)
    assert torch.equal(out, ref) and ragged_paged.LAUNCHES == n0


def test_ragged_block_defaults_and_override(monkeypatch):
    monkeypatch.delenv("TPUSERVE_RAGGED_BLOCK", raising=False)
    assert ragged_paged.ragged_block(device="cpu") == 8
    assert ragged_paged.ragged_block(device="cuda") == ragged_paged.CARD_BLOCK
    monkeypatch.setenv("TPUSERVE_RAGGED_BLOCK", "16")
    assert ragged_paged.ragged_block(device="cpu") == 16
    monkeypatch.setenv("TPUSERVE_RAGGED_BLOCK", "24")
    with pytest.raises(ValueError, match="power of two"):
        ragged_paged.ragged_block(device="cuda")
