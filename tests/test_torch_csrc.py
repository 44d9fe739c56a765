"""The CUDA sources on the CPU: the bf16 attention kernels run one Hopper
tile (``csrc/attn_tile.cuh``) on wgmma, and nothing of the WMMA tiles it
replaced is left; the decode kernels run one split-K body
(``csrc/paged_decode.cuh``) fed by an asynchronous K/V ring.  What the compiled code runs (HGMMA in the SASS) is
checked on the card by ``chip_smoke.py``'s build phase."""

import re

import pytest
import torch

from tpuserve_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SOURCES = sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _src(name: str) -> str:
    return (_build.CSRC / name).read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_no_wmma_tile_is_left(name):
    src = _src(name)
    assert "nvcuda::wmma" not in src and "<mma.h>" not in src


@pytest.mark.parametrize("name", ["flash_prefill.cu", "paged_window.cu", "ragged_paged.cu"])
def test_bf16_kernels_run_the_hopper_tile(name):
    assert "at::attn_tile<" in _src(name)


def test_the_tile_runs_wgmma_from_registers_and_shared_memory():
    src = _src("attn_tile.cuh")
    # S = Q K^T from shared memory, O += P V with P from registers
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    assert re.search(r"\}, \{%\d+, %\d+, %\d+, %\d+\}, %\d+, p, 1, 1, 1;", src)
    assert "cp.async.mbarrier.arrive.noinc" in src


@pytest.mark.parametrize("name", ["flash_prefill.cu", "paged_decode.cu", "paged_window.cu",
                                  "ragged_paged.cu"])
def test_each_source_note_names_the_tpu_kernel_it_replaces(name):
    note = _src(name).split("#include")[0]
    assert "Replaces the TPU kernel" in note and "tpuserve/ops/pallas_" in note
    assert "What bounds it on this card" in note


@pytest.mark.parametrize("name", ["paged_decode.cu", "ragged_paged.cu"])
def test_decode_rows_run_the_split_k_body(name):
    assert "split_decode<" in _src(name)


def test_the_split_k_body_streams_kv_through_an_async_ring():
    src = _src("paged_decode.cuh")
    assert "at::cp_async16" in src and "at::cp_async_arrive" in src and "at::mbar_wait" in src
    assert "atomicAdd(sk.counters" in src        # the last block merges, in the same launch
    note = _src("paged_decode.cu").split("#include")[0]
    assert "Known limit" not in note and "split" in note.lower()
