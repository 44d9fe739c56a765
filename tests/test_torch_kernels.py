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


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    dict(B=2, T=150, Hq=32, Hkv=32, D=96),                # Phi-3: 96 padded to 128
    dict(B=2, T=100, Hq=8, Hkv=2, D=96, window=40),
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
    dict(B=4, Hq=32, Hkv=32, D=96, page=16, nb=48, mp=8),  # Phi-3: 96 padded to 128
    dict(B=3, Hq=8, Hkv=2, D=96, page=8, nb=64, mp=8, int8=True, window=11),
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
    q = torch.zeros(1, 8, 4, 80, device=card)            # head_dim 80: no kernel takes it
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
    q80, c80 = torch.zeros(1, 4, 80, device=card), torch.zeros(4, 4, 2, 80, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode.paged_decode_attention(q80, c80, c80, bt, lens, 1.0)


def _nan_tailed(x, card):
    """``x`` on the card at the head of a buffer whose next 32 values are
    NaN: where a 96-wide last row would continue to 128 columns."""
    buf = torch.full((x.numel() + 32,), float("nan"), dtype=x.dtype, device=card)
    buf[:x.numel()] = x.flatten().to(card)
    return buf[:x.numel()].view(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_96_reads_no_column_past_96(card, dtype):
    """A planted fault: every tensor's last row is followed by NaN where
    its columns 96-127 would lie at a 128-wide stride, and the sequences
    attend that last row.  The kernels pad to 128 only in shared memory
    (zero columns, never copied into, never written): the outputs match
    the plain versions and hold no NaN."""
    rng = np.random.default_rng(96)
    B, T, H, D, page = 2, 64, 8, 96, 16
    q, k, v = (_nan_tailed(torch.from_numpy(rng.standard_normal((B, T, H, D), np.float32))
                           .to(dtype), card) for _ in range(3))
    lens = torch.full((B,), T, dtype=torch.int32, device=card)
    out = flash_prefill.flash_prefill_attention(q, k, v, lens, D ** -0.5)
    ref = attention.prefill_attention(q, k, v, lens, D ** -0.5)
    assert not out.isnan().any()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    nb = B * T // page                     # every block used; the last one last
    kc, vc = (_nan_tailed(torch.from_numpy(rng.standard_normal((nb, page, H, D), np.float32))
                          .to(dtype), card) for _ in range(2))
    bt = torch.arange(nb, dtype=torch.int32, device=card).view(B, T // page)
    qd = _nan_tailed(torch.from_numpy(rng.standard_normal((B, H, D), np.float32)).to(dtype),
                     card)
    out = paged_decode.paged_decode_attention(qd, kc, vc, bt, lens, D ** -0.5)
    ref = attention.paged_decode_attention(qd, kc, vc, bt, lens, D ** -0.5)
    assert not out.isnan().any()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    C = 16
    qw = _nan_tailed(torch.from_numpy(rng.standard_normal((B, C, H, D), np.float32)).to(dtype),
                     card)
    ctx = torch.full((B,), T - C, dtype=torch.int32, device=card)
    n = torch.full((B,), C, dtype=torch.int32, device=card)
    out = paged_window.paged_window_attention(qw, kc, vc, bt, ctx, n, D ** -0.5)
    ref = attention.chunked_prefill_attention(qw, kc, vc, bt, ctx, n, D ** -0.5)
    assert not out.isnan().any()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


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
    dict(B=2, C=48, Hq=32, Hkv=32, D=96, page=16, mp=8, ctx=[40, 0], n=[48, 30]),
    dict(B=2, C=40, Hq=8, Hkv=2, D=96, page=16, mp=8, ctx=[20, 5], n=[40, 17], int8=True),
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
    dict(n_dec=4, chunks=[(30, 70)], blk=16, Hq=32, Hkv=32, D=96),
    dict(n_dec=3, chunks=[(40, 90)], blk=32, Hq=8, Hkv=2, D=96, int8=True),
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


# The bf16 kernels share one Hopper tile (csrc/attn_tile.cuh): these cases
# walk its edges, held at the bf16 tolerance chip_smoke.py uses (atol a
# tenth of the reference's standard deviation, at most 2e-2; rtol 2e-2).

def _tile_tol(ref):
    return dict(atol=min(2e-2, 0.1 * ref.float().std().item()), rtol=2e-2)


def _nan_cache(rng, nb, page, Hkv, D, int8, card):
    """A cache whose every slot holds NaN (int8: 0 with NaN scales) until
    ``_write_slots`` fills the written ones."""
    if int8:
        kc = torch.zeros(nb, page, Hkv, D, dtype=torch.int8)
        ks = torch.full((nb, page, Hkv), float("nan"))
        return [kc, kc.clone(), ks, ks.clone()]
    kc = torch.full((nb, page, Hkv, D), float("nan"), dtype=torch.bfloat16)
    return [kc, kc.clone(), None, None]


def _write_slots(rng, cache, bt_row, n, page):
    """Random values into slots [0, n) of one sequence."""
    kc, vc, ks, vs = cache
    Hkv, D = kc.shape[2], kc.shape[3]
    for t in range(n):
        blk, off = int(bt_row[t // page]), t % page
        for c, s in ((kc, ks), (vc, vs)):
            x = torch.from_numpy(rng.standard_normal((Hkv, D), np.float32))
            if s is None:
                c[blk, off] = x.to(c.dtype)
            else:
                c[blk, off], s[blk, off] = attention.quantize_kv(x)


# B, C, Hq, Hkv, D, page, mp, ctx_lens, chunk_lens: groups 1 to 8, head
# dims 64 to 256, row counts off the 64/128-row tile (and a 1-row chunk),
# contexts starting mid-page or at 0, empty chunks, window + softcap, int8,
# pages of 1 and 2 keys (a 128-key tile then spans 128 or 64 pages)
TILE_WINDOW_CASES = [
    dict(B=2, C=130, Hq=4, Hkv=4, D=64, page=16, mp=12, ctx=[7, 0], n=[130, 1]),
    dict(B=3, C=200, Hq=16, Hkv=8, D=128, page=32, mp=16, ctx=[45, 300, 0], n=[200, 0, 129]),
    dict(B=2, C=70, Hq=8, Hkv=2, D=256, page=16, mp=8, ctx=[33, 5], n=[70, 65]),
    dict(B=2, C=17, Hq=8, Hkv=1, D=128, page=8, mp=16, ctx=[100, 64], n=[17, 1]),
    dict(B=2, C=150, Hq=16, Hkv=8, D=128, page=16, mp=48, ctx=[500, 20], n=[150, 140],
         window=100, softcap=30.0),
    dict(B=2, C=100, Hq=16, Hkv=8, D=128, page=32, mp=8, ctx=[70, 0], n=[100, 33], int8=True),
    dict(B=1, C=64, Hq=8, Hkv=2, D=64, page=4, mp=64, ctx=[130], n=[64], window=50,
         softcap=20.0, int8=True),
    dict(B=1, C=40, Hq=16, Hkv=2, D=256, page=16, mp=4, ctx=[10], n=[40], int8=True),
    dict(B=1, C=1, Hq=16, Hkv=8, D=64, page=32, mp=33, ctx=[1000], n=[1]),
    dict(B=1, C=100, Hq=16, Hkv=8, D=128, page=1, mp=260, ctx=[150], n=[100]),
    dict(B=2, C=90, Hq=16, Hkv=8, D=128, page=2, mp=150, ctx=[200, 3], n=[90, 60]),
]


@pytest.mark.parametrize("c", TILE_WINDOW_CASES)
def test_paged_window_tile_edges(card, c):
    rng = np.random.default_rng(c["C"] * 7 + c["D"])
    B, C, page, mp = c["B"], c["C"], c["page"], c["mp"]
    nb = B * mp + 3
    cache = _nan_cache(rng, nb, page, c["Hkv"], c["D"], c.get("int8"), card)
    bt = rng.permutation(nb)[:B * mp].reshape(B, mp).astype(np.int32)
    for b in range(B):                     # only the written slots hold numbers
        _write_slots(rng, cache, bt[b], c["ctx"][b] + c["n"][b], page)
    kc, vc, ks, vs = (x if x is None else x.to(card) for x in cache)
    q = torch.from_numpy(rng.standard_normal((B, C, c["Hq"], c["D"]), np.float32))
    ctx = torch.tensor(c["ctx"], dtype=torch.int32, device=card)
    n = torch.tensor(c["n"], dtype=torch.int32, device=card)
    args = (q.to(card, torch.bfloat16), kc, vc, torch.from_numpy(bt).to(card), ctx, n,
            c["D"] ** -0.5)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=c.get("window"),
              logit_softcap=c.get("softcap"))
    out = paged_window.paged_window_attention(*args, **kw)
    ref = attention.chunked_prefill_attention(*args, **kw)
    rows = [ref[b, :c["n"][b]] for b in range(B)]
    tol = _tile_tol(torch.cat([r.flatten() for r in rows]))
    for b in range(B):
        nb_ = c["n"][b]
        torch.testing.assert_close(out[b, :nb_].float(), rows[b].float(), **tol)
        assert torch.count_nonzero(out[b, nb_:]) == 0


# (G, D, window, softcap) over prompt lengths 1, 63, 64, 65 and T, NaN
# past each prompt
TILE_FLASH_CASES = [(1, 64, None, None), (2, 128, None, None), (4, 256, None, None),
                    (8, 128, None, None), (2, 64, 40, 30.0), (2, 256, 70, None),
                    (1, 96, None, None), (4, 96, 40, 30.0)]


@pytest.mark.parametrize("G,D,window,softcap", TILE_FLASH_CASES)
def test_flash_prefill_tile_edges(card, G, D, window, softcap):
    rng = np.random.default_rng(G * D)
    T, Hkv = 130, 2
    lens = np.asarray([1, 63, 64, 65, T], np.int32)
    B = len(lens)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, h, D), np.float32))
               for h in (G * Hkv, Hkv, Hkv))
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    q, k, v = (x.to(card, torch.bfloat16) for x in (q, k, v))
    plens = torch.from_numpy(lens).to(card)
    kw = dict(sliding_window=window, logit_softcap=softcap)
    out = flash_prefill.flash_prefill_attention(q, k, v, plens, D ** -0.5, **kw)
    ref = attention.prefill_attention(q, k, v, plens, D ** -0.5, **kw)
    tol = _tile_tol(torch.cat([ref[b, :n].flatten() for b, n in enumerate(lens)]))
    for b, n in enumerate(lens):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(), **tol)


# ragged prefill blocks on the tile: groups 4 and 8 at D=256 and 64, a
# 1-row chunk, int8 with a window
TILE_RAGGED_CASES = [
    dict(n_dec=3, chunks=[(1, 1), (77, 140)], blk=16, Hq=8, Hkv=2, D=256),
    dict(n_dec=2, chunks=[(50, 50), (1, 300)], blk=32, Hq=16, Hkv=2, D=64),
    dict(n_dec=4, chunks=[(90, 200)], blk=64, int8=True, window=60, softcap=30.0),
]


@pytest.mark.parametrize("c", TILE_RAGGED_CASES)
def test_ragged_paged_tile_edges(card, c):
    rng = np.random.default_rng(c["blk"] + 11 * c["n_dec"])
    shape = {k: c[k] for k in ("Hq", "Hkv", "D") if k in c}
    args, kw, valid = _ragged(rng, card, torch.bfloat16, c["n_dec"], c["chunks"], c["blk"],
                              int8=c.get("int8", False), mp=24, **shape)
    kw.update(sliding_window=c.get("window"), logit_softcap=c.get("softcap"))
    scale = args[0].shape[-1] ** -0.5
    out = ragged_paged.ragged_paged_attention(*args, scale, c["blk"], **kw)
    ref = attention.ragged_paged_attention(*args, scale, c["blk"], **kw)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(), **_tile_tol(ref[valid]))
    assert torch.count_nonzero(out[~valid]) == 0


# Split-K paged decode (csrc/paged_decode.cuh): each sequence's keys are cut
# into partitions of whole pages, sized from the shapes and the card's SM
# count (paged_decode.decode_splits), so lengths are given as functions of
# the partition's keys `p` and the table's `full` width.  Every unwritten
# slot holds NaN (int8: NaN scales); each case runs twice in a row, which
# only agrees if the merge counters went back to 0.
SPLIT_CASES = [
    # lengths at partition - 1, partition, partition + 1 (the decode headline)
    dict(B=8, Hq=16, Hkv=8, D=128, page=32, mp=64,
         lens=lambda p, full: [p - 1, p, p + 1, 2 * p - 1, 2 * p, 2 * p + 1, full - 1, 0]),
    # one sequence at the table's full width beside an empty one
    dict(B=2, Hq=16, Hkv=8, D=128, page=16, mp=32, lens=lambda p, full: [full, 0]),
    # a sliding window that starts in a later partition
    dict(B=4, Hq=16, Hkv=8, D=128, page=16, mp=64, window=100,
         lens=lambda p, full: [full, full - 37, 3 * p + 5, 0]),
    # G = 8 at D = 256
    dict(B=3, Hq=16, Hkv=2, D=256, page=16, mp=32, lens=lambda p, full: [full, p + 1, 1]),
    # int8 pages with a window
    dict(B=4, Hq=16, Hkv=8, D=128, page=32, mp=64, int8=True, window=300,
         lens=lambda p, full: [full, 2 * p + 3, p - 1, 0]),
    # float32, window and softcap, small pages
    dict(B=4, Hq=8, Hkv=2, D=64, page=8, mp=64, window=50, softcap=30.0,
         dtype=torch.float32, lens=lambda p, full: [full, p, p + 1, 0]),
]


@pytest.mark.parametrize("c", SPLIT_CASES)
def test_paged_decode_split_edges(card, c):
    B, page, mp, Hkv = c["B"], c["page"], c["mp"], c["Hkv"]
    dtype = c.get("dtype", torch.bfloat16)
    _, part_pages = paged_decode.decode_splits(mp, page, B, Hkv,
                                                 paged_decode.num_sms(card))
    lens = c["lens"](part_pages * page, mp * page)
    rng = np.random.default_rng(B * c["D"] + mp)
    nb = B * mp + 3
    cache = _nan_cache(rng, nb, page, Hkv, c["D"], c.get("int8"), card)
    if dtype == torch.float32 and not c.get("int8"):
        cache[0], cache[1] = cache[0].float(), cache[1].float()
    bt = rng.permutation(nb)[:B * mp].reshape(B, mp).astype(np.int32)
    for b in range(B):                     # only the written slots hold numbers
        _write_slots(rng, cache, bt[b], lens[b], page)
    kc, vc, ks, vs = (x if x is None else x.to(card) for x in cache)
    q = torch.from_numpy(rng.standard_normal((B, c["Hq"], c["D"]), np.float32))
    args = (q.to(card, dtype), kc, vc, torch.from_numpy(bt).to(card),
            torch.tensor(lens, dtype=torch.int32, device=card), c["D"] ** -0.5)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=c.get("window"),
              logit_softcap=c.get("softcap"))
    n0 = paged_decode.LAUNCHES
    out = paged_decode.paged_decode_attention(*args, **kw)
    again = paged_decode.paged_decode_attention(*args, **kw)
    ref = attention.paged_decode_attention(*args, **kw)
    assert paged_decode.LAUNCHES == n0 + 2
    assert torch.equal(out, again)
    tol = TOL[dtype] if dtype == torch.float32 else _tile_tol(ref)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(out[b]) == 0


def test_ragged_decode_rows_twice_in_a_row(card):
    """The ragged kernel's decode rows run the split-K body with its merge
    counters: two calls in a row agree, and agree with the plain version."""
    rng = np.random.default_rng(9)
    args, kw, valid = _ragged(rng, card, torch.bfloat16, 3, [(60, 200)], 32, mp=64)
    scale = 128 ** -0.5
    out = ragged_paged.ragged_paged_attention(*args, scale, 32, **kw)
    again = ragged_paged.ragged_paged_attention(*args, scale, 32, **kw)
    ref = attention.ragged_paged_attention(*args, scale, 32, **kw)
    assert torch.equal(out, again)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(), **_tile_tol(ref[valid]))


# ---- captured decode graphs ---------------------------------------------------

def _narrow_engine_parts(card, dtype):
    """A narrow Qwen3-family model (2 layers, head_dim 64) with random
    weights and a random cache on the card."""
    import dataclasses
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.runtime import kv_cache
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), head_dim=64,
                              dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = init_params(cfg, 0, card)
    cc = kv_cache.CacheConfig(block_size=16, num_blocks=40, max_blocks_per_seq=8,
                              dtype=cfg.dtype)
    g = torch.Generator(device=card).manual_seed(3)
    cache = kv_cache.create_kv_cache(cfg, cc, card)
    for e in cache:
        for t in e.values():
            t.copy_(torch.randn(t.shape, generator=g, device=card))
    return cfg, params, cache


def _stage(exe, rows):
    st = exe.stage()
    for i, (tok, pos) in enumerate(rows):
        st.tokens[i], st.positions[i], st.seq_lens[i] = tok, pos, pos + 1
        st.active[i] = 1
        st.salt[i], st.step[i], st.temperature[i] = 1000 + i, pos, 0.8 if i % 2 else 0.0
        st.block_tables[i] = np.arange(8 * i, 8 * i + 8) % 40
    return st


@pytest.mark.parametrize("mode", ["greedy", "temperature"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_replay_is_bit_equal_to_eager(card, mode, dtype):
    """One decode iteration captured and replayed gives the bits of the
    same iteration run eagerly on the same inputs (the same kernels in
    the same order): logits, tokens and the cache, over a 6-step window;
    the paged decode kernel's launches count through the replays."""
    from tpuserve_torch.runtime.graphs import StepGraphs
    cfg, params, cache = _narrow_engine_parts(card, dtype)
    eager_cache = [{k: t.clone() for k, t in e.items()} for e in cache]
    rows = [(5, 17), (9, 40), (33, 3)]           # 3 real rows in a bucket of 4
    runs = {}
    for name, kv, capture in (("graph", cache, True), ("eager", eager_cache, False)):
        graphs = StepGraphs(params, cfg, kv, device=card, attn_impl="cuda",
                            max_blocks=8, steps=6, max_batch=8, capture=capture)
        exe = graphs.get("decode", 4, mode)
        n0 = paged_decode.LAUNCHES
        exe.load(_stage(exe, rows))
        exe.run(6)
        torch.cuda.synchronize()
        runs[name] = (exe.state.out.clone(), exe.logits.clone(), paged_decode.LAUNCHES - n0)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert torch.equal(runs["graph"][1], runs["eager"][1])
    assert runs["graph"][2] == runs["eager"][2] == 6 * cfg.num_layers
    for a, b in zip(cache, eager_cache):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_paged_decode_replayed_matches_plain(card):
    """The paged decode kernel captured once and replayed on new inputs
    copied into its static tensors matches its plain version on each; a
    replay does not call the wrapper, so it counts nothing itself."""
    rng = np.random.default_rng(21)
    B, Hq, Hkv, D, page, nb, mp = 4, 16, 8, 128, 32, 64, 16
    kc, vc = (torch.from_numpy(rng.standard_normal((nb, page, Hkv, D), np.float32))
              .to(card, torch.bfloat16) for _ in "kv")
    q = torch.zeros(B, Hq, D, device=card, dtype=torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(nb)[:B * mp].reshape(B, mp).astype(np.int32)).to(card)
    sl = torch.ones(B, dtype=torch.int32, device=card)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):              # the workspace exists before capture
        paged_decode.paged_decode_attention(q, kc, vc, bt, sl, D ** -0.5)
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = paged_decode.paged_decode_attention(q, kc, vc, bt, sl, D ** -0.5)
    n0 = paged_decode.LAUNCHES
    for trial in range(3):
        q.copy_(torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32)))
        sl.copy_(torch.from_numpy(rng.integers(1, page * mp + 1, B).astype(np.int32)))
        graph.replay()
        ref = attention.paged_decode_attention(q, kc, vc, bt, sl, D ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    assert paged_decode.LAUNCHES == n0


def _step_inputs(kind):
    """A prefill of 20 and 7 tokens in a (2, 32) batch; a 25-row chunk at
    cached offset 40 in a 32-row bucket; two decode rows and a 20-row
    chunk at offset 30 in a 64-row mixed stream (block 32, 4 sequences)."""
    page, mb = 16, 8

    def slots(seq, start, n):
        t = np.arange(start, start + n)
        return seq * mb * page + t

    if kind == "prefill":
        a = {"tokens": np.zeros((2, 32), np.int32), "prompt_lens": [20, 7],
             "slot_ids": np.full((2, 32), attention.PAD_SLOT, np.int32)}
        for i, n in enumerate((20, 7)):
            a["tokens"][i, :n], a["slot_ids"][i, :n] = np.arange(n) + 3 * i, slots(i, 0, n)
        return ("prefill", 2, 32), a
    if kind == "chunk":
        a = {"tokens": np.zeros((1, 32), np.int32), "ctx_lens": [40], "chunk_lens": [25],
             "slot_ids": np.full((1, 32), attention.PAD_SLOT, np.int32),
             "block_tables": np.arange(16, 24, dtype=np.int32)[None]}
        a["tokens"][0, :25], a["slot_ids"][0, :25] = np.arange(25) + 5, slots(2, 40, 25)
        return ("chunk", 32), a
    starts, T, meta, blk_seq = ragged_layout(2, [20], 32)
    a = {"tokens": np.zeros(T, np.int32), "positions": np.zeros(T, np.int32),
         "slot_ids": np.full(T, attention.PAD_SLOT, np.int32), "row_seq": np.zeros(T, np.int32),
         "block_tables": np.zeros((4, mb), np.int32), "kv_lens": np.zeros(4, np.int32),
         "q_starts": np.full(4, T, np.int32), "q_lens": np.zeros(4, np.int32), "meta": meta,
         "blk_seq": blk_seq, "last_rows": np.zeros(4, np.int32)}
    for i, pos in enumerate((50, 60)):
        a["tokens"][i], a["positions"][i], a["slot_ids"][i] = 7 + i, pos, slots(i, pos, 1)[0]
        a["row_seq"][i] = a["q_starts"][i] = a["last_rows"][i] = i
        a["kv_lens"][i], a["q_lens"][i] = pos + 1, 1
        a["block_tables"][i] = np.arange(i * mb, i * mb + mb)
    st = starts[0]
    a["tokens"][st:st + 20], a["positions"][st:st + 20] = np.arange(20) + 9, 30 + np.arange(20)
    a["slot_ids"][st:st + 20], a["row_seq"][st:st + 20] = slots(2, 30, 20), 2
    a["kv_lens"][2], a["q_starts"][2], a["q_lens"][2], a["last_rows"][2] = 50, st, 20, st + 19
    a["block_tables"][2] = np.arange(2 * mb, 3 * mb)
    return ("mixed", T), a


@pytest.mark.parametrize("kind", ["prefill", "chunk", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_graph_replay_is_bit_equal_to_eager(card, kind, dtype):
    """A prefill, chunk or mixed step captured and replayed gives the bits
    of the same step run eagerly on the same inputs: logits and cache,
    padding rows included; its kernel's launches count through the
    replay, once a layer."""
    from tpuserve_torch.runtime.graphs import StepGraphs
    cfg, params, cache = _narrow_engine_parts(card, dtype)
    eager_cache = [{k: t.clone() for k, t in e.items()} for e in cache]
    key, inputs = _step_inputs(kind)
    mod = {"prefill": flash_prefill, "chunk": paged_window, "mixed": ragged_paged}[kind]
    runs = {}
    for name, kv, capture in (("graph", cache, True), ("eager", eager_cache, False)):
        graphs = StepGraphs(params, cfg, kv, device=card, attn_impl="cuda", max_blocks=8,
                            steps=1, max_batch=4, ragged_blk=32, capture=capture)
        exe = graphs.get(*key)
        st = exe.stage()
        for field, arr in inputs.items():
            getattr(st, field)[...] = arr
        n0 = mod.LAUNCHES
        exe.load(st)
        exe.run()
        torch.cuda.synchronize()
        runs[name] = (exe.logits.clone(), mod.LAUNCHES - n0)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert runs["graph"][1] == runs["eager"][1] == cfg.num_layers
    assert torch.isfinite(runs["graph"][0]).all()
    for a, b in zip(cache, eager_cache):
        for k in a:
            assert torch.equal(a[k], b[k])
