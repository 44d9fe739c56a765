"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: float32 atol 1e-4 (the same math summed in another order);
bfloat16 atol and rtol 2e-2 (the kernel rounds the probabilities to bf16
at another point than the plain version).
"""

import numpy as np
import pytest
import torch

from tpuserve_torch.ops import attention, flash_prefill, paged_decode

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
