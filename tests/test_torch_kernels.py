"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: float32 atol 1e-4 (the same math summed in another order);
bfloat16 atol and rtol 2e-2 (the kernel rounds the probabilities to bf16
at another point than the plain version).  Rows past a window's
``chunk_lens`` and ragged rows that serve no query are unspecified for the
plain versions; the kernels write them as 0, which is checked on its own.
"""

import numpy as np
import pytest
import torch

from tpuserve_torch.ops import (attention, flash_prefill, paged_decode, paged_window,
                                ragged_paged)
from tpuserve_torch.ops.ragged_paged import ragged_layout

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


FLASH_CASES = [
    dict(B=2, T=200, Hq=8, Hkv=2, D=128),
    dict(B=3, T=64, Hq=4, Hkv=4, D=64),
    dict(B=1, T=130, Hq=4, Hkv=1, D=256),
    dict(B=2, T=300, Hq=8, Hkv=4, D=64, window=50, softcap=30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", FLASH_CASES)
def test_flash_prefill_kernel_matches_plain(card, c, dtype):
    rng = np.random.default_rng(c["T"])
    B, T = c["B"], c["T"]
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, h, c["D"]), np.float32))
               for h in (c["Hq"], c["Hkv"], c["Hkv"]))
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    for b, n in enumerate(lens):               # padding keys hold NaN
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    q, k, v = (x.to(card, dtype) for x in (q, k, v))
    plens = torch.from_numpy(lens).to(card)
    kw = dict(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    n0 = flash_prefill.LAUNCHES
    out = flash_prefill.flash_prefill_attention(q, k, v, plens, c["D"] ** -0.5, **kw)
    ref = attention.prefill_attention(q, k, v, plens, c["D"] ** -0.5, **kw)
    assert flash_prefill.LAUNCHES == n0 + 1
    for b, n in enumerate(lens):               # rows past the prompt are unspecified
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(), **TOL[dtype])


PAGED_CASES = [
    dict(B=2, Hq=4, Hkv=2, D=64, page=4, nb=16, mp=4),
    dict(B=8, Hq=16, Hkv=8, D=128, page=32, nb=80, mp=8),
    dict(B=3, Hq=8, Hkv=1, D=256, page=16, nb=32, mp=8),
    dict(B=5, Hq=4, Hkv=2, D=128, page=8, nb=64, mp=8, int8=True),
    dict(B=4, Hq=8, Hkv=2, D=64, page=4, nb=64, mp=8, window=7, softcap=20.0),
    dict(B=4, Hq=4, Hkv=2, D=128, page=4, nb=64, mp=8, int8=True, window=9),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", PAGED_CASES)
def test_paged_decode_kernel_matches_plain(card, c, dtype):
    rng = np.random.default_rng(c["B"] * c["D"])
    q = torch.from_numpy(rng.standard_normal((c["B"], c["Hq"], c["D"]), np.float32))
    shape = (c["nb"], c["page"], c["Hkv"], c["D"])
    kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32)) for _ in "kv")
    bt = rng.permutation(c["nb"])[:c["B"] * c["mp"]].reshape(c["B"], c["mp"])
    sl = rng.integers(1, c["page"] * c["mp"] + 1, c["B"]).astype(np.int32)
    sl[0] = c["page"] * c["mp"]
    sl[-1] = 0                                 # a padding row writes zeros
    ks = vs = None
    if c.get("int8"):
        kc, ks = attention.quantize_kv(kc)
        vc, vs = attention.quantize_kv(vc)
        ks, vs = ks.to(card), vs.to(card)
    else:
        for b, n in enumerate(sl):             # slots past the end hold NaN
            for t in range(n, c["page"] * c["mp"]):
                kc[bt[b, t // c["page"]], t % c["page"]] = float("nan")
                vc[bt[b, t // c["page"]], t % c["page"]] = float("nan")
        kc, vc = kc.to(dtype), vc.to(dtype)
    args = (q.to(card, dtype), kc.to(card), vc.to(card),
            torch.from_numpy(bt.astype(np.int32)).to(card), torch.from_numpy(sl).to(card),
            c["D"] ** -0.5)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=c.get("window"),
              logit_softcap=c.get("softcap"))
    n0 = paged_decode.LAUNCHES
    out = paged_decode.paged_decode_attention(*args, **kw)
    ref = attention.paged_decode_attention(*args, **kw)
    assert paged_decode.LAUNCHES == n0 + 1
    assert torch.count_nonzero(out[-1]) == 0
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 8, 4, 96, device=card)            # head_dim 96
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill.flash_prefill_attention(q, q, q, lens, 1.0)
    q = torch.zeros(1, 8, 4, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_prefill.flash_prefill_attention(q, q, q, lens, 1.0)
    q = torch.zeros(1, 4, 64, device=card)
    cache = torch.zeros(4, 4, 2, 64, device=card, dtype=torch.bfloat16)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="cache dtype"):
        paged_decode.paged_decode_attention(q, cache, cache, bt, lens, 1.0)


def _cache(rng, nb, page, Hkv, D, dtype, int8, card):
    """Random K/V pages on the card: q's dtype, or int8 with scales."""
    kc, vc = (torch.from_numpy(rng.standard_normal((nb, page, Hkv, D), np.float32))
              for _ in "kv")
    if int8:
        kc, ks = attention.quantize_kv(kc)
        vc, vs = attention.quantize_kv(vc)
        return kc.to(card), vc.to(card), ks.to(card), vs.to(card)
    return kc.to(card, dtype), vc.to(card, dtype), None, None


def _poison(kc, vc, bt_row, positions, page):
    """NaN into the (unwritten) slots at ``positions`` of one sequence; an
    int8 cache cannot hold NaN and is left as it is."""
    if kc.dtype == torch.int8:
        return
    for t in positions:
        kc[int(bt_row[t // page]), t % page] = float("nan")
        vc[int(bt_row[t // page]), t % page] = float("nan")


# B, C, Hq, Hkv, D, page, mp, ctx_lens, chunk_lens: (a) NaN past each
# window, (b) rows past the chunk, (c) the 32-row bucket and ctx 0, (d) int8
# and sliding windows, groups 1 to 8 and head dims 64 to 256
WINDOW_CASES = [
    dict(B=2, C=64, Hq=8, Hkv=4, D=128, page=16, mp=16, ctx=[100, 0], n=[64, 37]),
    dict(B=1, C=32, Hq=4, Hkv=4, D=64, page=8, mp=8, ctx=[0], n=[20]),
    dict(B=3, C=48, Hq=16, Hkv=2, D=128, page=32, mp=8, ctx=[17, 150, 3], n=[48, 1, 30]),
    dict(B=1, C=40, Hq=8, Hkv=1, D=256, page=16, mp=8, ctx=[60], n=[40]),
    dict(B=2, C=64, Hq=16, Hkv=8, D=128, page=32, mp=8, ctx=[130, 5], n=[64, 50], int8=True),
    dict(B=2, C=32, Hq=8, Hkv=2, D=64, page=4, mp=32, ctx=[90, 2], n=[32, 20], window=24,
         softcap=30.0),
    dict(B=1, C=96, Hq=6, Hkv=2, D=64, page=16, mp=16, ctx=[40], n=[90], window=50),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", WINDOW_CASES)
def test_paged_window_kernel_matches_plain(card, c, dtype):
    rng = np.random.default_rng(c["C"] + c["D"])
    B, C, page, mp = c["B"], c["C"], c["page"], c["mp"]
    nb = B * mp + 3
    q = torch.from_numpy(rng.standard_normal((B, C, c["Hq"], c["D"]), np.float32))
    kc, vc, ks, vs = _cache(rng, nb, page, c["Hkv"], c["D"], dtype, c.get("int8"), card)
    bt = rng.permutation(nb)[:B * mp].reshape(B, mp).astype(np.int32)
    ctx = np.asarray(c["ctx"], np.int32)
    n = np.asarray(c["n"], np.int32)
    for b in range(B):                     # unwritten slots past each window
        _poison(kc, vc, bt[b], range(int(ctx[b] + n[b]), mp * page), page)
        if c.get("window"):                # and before its first row's window
            _poison(kc, vc, bt[b], range(0, max(int(ctx[b]) - c["window"] + 1, 0)), page)
    args = (q.to(card, dtype), kc, vc, torch.from_numpy(bt).to(card),
            torch.from_numpy(ctx).to(card), torch.from_numpy(n).to(card), c["D"] ** -0.5)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=c.get("window"),
              logit_softcap=c.get("softcap"))
    n0 = paged_window.LAUNCHES
    out = paged_window.paged_window_attention(*args, **kw)
    ref = attention.chunked_prefill_attention(*args, **kw)
    assert paged_window.LAUNCHES == n0 + 1
    for b in range(B):
        torch.testing.assert_close(out[b, :n[b]].float(), ref[b, :n[b]].float(),
                                   **TOL[dtype])
        assert torch.count_nonzero(out[b, n[b]:]) == 0


def _ragged(rng, card, dtype, n_dec, chunks, blk, Hq=16, Hkv=8, D=128, page=16, mp=16,
            int8=False, poison=True):
    """A mixed stream packed as the engine packs it (ragged_layout): decode
    rows of random lengths, then ``chunks`` ((q_len, kv_len) each).  Returns
    the kernel's arguments, the valid-row mask and the decode lengths."""
    B = n_dec + len(chunks)
    nb = B * mp + 3
    kc, vc, ks, vs = _cache(rng, nb, page, Hkv, D, dtype, int8, card)
    bt = rng.permutation(nb)[:B * mp].reshape(B, mp).astype(np.int32)
    kv = np.concatenate([rng.integers(1, mp * page + 1, n_dec),
                         [kl for _, kl in chunks]]).astype(np.int32)
    starts, T, meta, blk_seq = ragged_layout(n_dec, [ql for ql, _ in chunks], blk)
    q_starts = np.concatenate([np.arange(n_dec), starts]).astype(np.int32)
    q_lens = np.asarray([1] * n_dec + [ql for ql, _ in chunks], np.int32)
    valid = np.zeros(T, bool)
    for s in range(B):
        valid[q_starts[s]:q_starts[s] + q_lens[s]] = True
        if poison:
            _poison(kc, vc, bt[s], range(int(kv[s]), mp * page), page)
    q = torch.from_numpy(rng.standard_normal((T, Hq, D), np.float32)).to(card, dtype)
    args = [q, kc, vc] + [torch.from_numpy(x).to(card) for x in (
        bt, kv, q_starts, q_lens, meta, blk_seq)]
    return args, dict(k_scale=ks, v_scale=vs), torch.from_numpy(valid).to(card)


# n_dec, (q_len, kv_len) chunks, blk: (e) every block size from 8 to 128,
# decode rows only, chunks only, int8, window + softcap, groups 1 and 8
RAGGED_CASES = [
    dict(n_dec=8, chunks=[(100, 180), (37, 37), (64, 200)], blk=32),
    dict(n_dec=5, chunks=[(30, 90), (9, 9)], blk=8),
    dict(n_dec=3, chunks=[(50, 70)], blk=16),
    dict(n_dec=8, chunks=[(130, 250), (5, 40)], blk=64),
    dict(n_dec=2, chunks=[(200, 230)], blk=128),
    dict(n_dec=16, chunks=[], blk=32),
    dict(n_dec=0, chunks=[(96, 96), (33, 150)], blk=32),
    dict(n_dec=6, chunks=[(40, 120)], blk=32, int8=True),
    dict(n_dec=6, chunks=[(70, 100)], blk=16, window=40, softcap=30.0),
    dict(n_dec=4, chunks=[(20, 60)], blk=8, Hq=8, Hkv=8, D=64),
    dict(n_dec=4, chunks=[(20, 60)], blk=32, Hq=8, Hkv=1, D=256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", RAGGED_CASES)
def test_ragged_paged_kernel_matches_plain(card, c, dtype):
    rng = np.random.default_rng(c["blk"] + 7 * c["n_dec"])
    shape = {k: c[k] for k in ("Hq", "Hkv", "D") if k in c}
    args, kw, valid = _ragged(rng, card, dtype, c["n_dec"], c["chunks"], c["blk"],
                              int8=c.get("int8", False), **shape)
    kw.update(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    n0 = ragged_paged.LAUNCHES
    out = ragged_paged.ragged_paged_attention(*args, args[0].shape[-1] ** -0.5, c["blk"],
                                              **kw)
    ref = attention.ragged_paged_attention(*args, args[0].shape[-1] ** -0.5, c["blk"], **kw)
    assert ragged_paged.LAUNCHES == n0 + 1
    torch.testing.assert_close(out[valid].float(), ref[valid].float(), **TOL[dtype])
    assert torch.count_nonzero(out[~valid]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_rows_match_the_paged_decode_kernel(card, dtype):
    """(g): decode rows of a mixed step agree with the phase-split decode
    kernel on the same rows."""
    rng = np.random.default_rng(5)
    n_dec = 8
    args, kw, _ = _ragged(rng, card, dtype, n_dec, [(100, 250)], 32)
    q, kc, vc, bt, kv = args[:5]
    out = ragged_paged.ragged_paged_attention(*args, 128 ** -0.5, 32, **kw)
    dec = paged_decode.paged_decode_attention(q[:n_dec].contiguous(), kc, vc,
                                              bt[:n_dec].contiguous(),
                                              kv[:n_dec].contiguous(), 128 ** -0.5, **kw)
    torch.testing.assert_close(out[:n_dec].float(), dec.float(), **TOL[dtype])


def test_new_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 32, 4, 64, device=card, dtype=torch.bfloat16)
    cache = torch.zeros(4, 4, 2, 64, device=card)             # float32 cache, bf16 q
    bt = torch.zeros(1, 2, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="cache dtype"):
        paged_window.paged_window_attention(q, cache, cache, bt, lens, lens, 1.0)
    with pytest.raises(ValueError, match="ctx_lens"):
        paged_window.paged_window_attention(q, cache.bfloat16(), cache.bfloat16(), bt,
                                            lens.long(), lens, 1.0)
    flat = torch.zeros(48, 4, 64, device=card, dtype=torch.bfloat16)
    meta = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of the block"):
        ragged_paged.ragged_paged_attention(flat, cache.bfloat16(), cache.bfloat16(), bt,
                                            lens, lens, lens, meta, meta, 1.0, 32)
    with pytest.raises(ValueError, match="blk_seq"):
        ragged_paged.ragged_paged_attention(flat[:32], cache.bfloat16(), cache.bfloat16(),
                                            bt, lens, lens, lens, meta, meta, 1.0, 8)
