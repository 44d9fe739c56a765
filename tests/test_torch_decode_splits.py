"""The host side of the split-K decode kernels, on the CPU: how
``paged_decode.decode_splits`` cuts a row's keys into partitions of whole
pages, which keys each block then reads (``partitions`` below, the rule
``split_decode`` in ``csrc/paged_decode.cuh`` applies), and the sizes of the
ragged kernel's decode part and of the partial records.  The kernels
themselves run only on the card (``tests/test_torch_kernels.py``)."""

import pytest
import torch

from tpuserve_torch.ops import paged_decode
from tpuserve_torch.ops.paged_decode import (MIN_KEYS, WAVES, decode_splits,
                                             ragged_decode_blocks, split_stride)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def partitions(seq_len, window, splits, part_pages, page):
    """(split, lo, hi) of each block that reads keys for a row of
    ``seq_len`` keys: keys [lo, hi) of partition ``split``, as
    ``split_decode`` clamps, skips and cuts them; the row's other blocks read
    nothing."""
    part_keys = part_pages * page
    seq_len = min(seq_len, splits * part_keys)
    if seq_len <= 0:
        return []
    win = max(seq_len - window, 0) if window else 0
    return [(s, max(win, s * part_keys), min(seq_len, (s + 1) * part_keys))
            for s in range(win // part_keys, (seq_len - 1) // part_keys + 1)]


# (max_pages, page, rows, Hkv, num_sms): the decode headline and the main
# path (B=8, Qwen3's 8 KV heads, 64 pages of 32), one sequence alone, a
# large batch, pages of 1 key, a table narrower than the split wanted
SHAPES = [(64, 32, 8, 8, 132), (64, 32, 1, 8, 132), (64, 32, 64, 8, 132),
          (260, 1, 2, 2, 132), (3, 16, 1, 1, 132), (8, 4, 3, 2, 4), (1, 32, 5, 8, 132)]


@pytest.mark.parametrize("window", [None, 1, 7, 100, 5000])
@pytest.mark.parametrize("max_pages,page,rows,Hkv,sms", SHAPES)
def test_every_attended_key_falls_in_exactly_one_partition(max_pages, page, rows, Hkv, sms,
                                                           window):
    splits, part_pages = decode_splits(max_pages, page, rows, Hkv, sms)
    assert 1 <= splits <= max_pages and (splits - 1) * part_pages < max_pages
    part_keys = part_pages * page
    for seq_len in range(max_pages * page + 1):
        win = max(seq_len - window, 0) if window else 0
        seen = []
        for s, lo, hi in partitions(seq_len, window, splits, part_pages, page):
            assert 0 <= s < splits and lo < hi
            # inside its partition, which is a whole number of pages
            assert s * part_keys <= lo and hi <= (s + 1) * part_keys
            seen.extend(range(lo, hi))
        assert seen == list(range(win, seq_len)), (seq_len, window)


def test_a_row_past_the_table_reads_no_partition_that_has_no_block():
    splits, part_pages = decode_splits(4, 16, 1, 1, 132)
    parts = partitions(10 ** 6, None, splits, part_pages, 16)
    assert [s for s, _, _ in parts] == list(range(splits))
    assert parts[-1][2] == 4 * 16


@pytest.mark.parametrize("rows", [1, 2, 8, 16, 64])
def test_the_splits_spread_a_row_over_blocks_of_min_keys_or_more(rows):
    """At the main path's shapes (64 pages of 32 keys a row, 8 KV heads)
    each row is split over several blocks, where a (B, Hkv) grid would
    hold 64 at B=8 on 132 SMs, with no partition under MIN_KEYS keys and
    no more blocks than WAVES an SM and one a (row, KV head)."""
    splits, part_pages = decode_splits(64, 32, rows, 8, 132)
    assert splits > 1 and part_pages * 32 >= MIN_KEYS
    assert rows * 8 * splits <= WAVES * 132 + rows * 8


@pytest.mark.parametrize("max_pages,page", [(64, 32), (3, 16), (5, 1), (300, 1), (9, 16),
                                            (1, 32), (1000, 32)])
def test_no_partition_is_shorter_than_min_keys_unless_the_table_is(max_pages, page):
    for rows in (1, 3, 8, 64):
        _, part_pages = decode_splits(max_pages, page, rows, 8, 132)
        assert part_pages * page >= min(MIN_KEYS, max_pages * page)


def test_decode_headline_partitions():
    """B=8 and B=1 at 64 pages of 32 keys: 16 partitions of 128 keys, so one
    2,048-key sequence runs as 16 x 8 blocks."""
    assert decode_splits(64, 32, 8, 8, 132) == (16, 4)
    assert decode_splits(64, 32, 1, 8, 132) == (16, 4)


@pytest.mark.parametrize("rows,Hkv,max_pages,page,sms", [
    (64, 8, 64, 32, 132), (9, 8, 31, 32, 132), (1, 8, 64, 32, 132), (16, 2, 16, 16, 4),
    (32, 1, 300, 1, 132), (64, 8, 4096, 32, 132)])
def test_ragged_decode_part_holds_every_decode_row_count(rows, Hkv, max_pages, page, sms):
    """The ragged kernel learns its decode-row count n on the card and takes
    n x Hkv x splits(n) blocks of a decode part sized on the host."""
    budget = ragged_decode_blocks(rows, Hkv, max_pages, page, sms)
    items = [n * Hkv * decode_splits(max_pages, page, n, Hkv, sms)[0]
             for n in range(rows + 1)]
    assert budget == max(items)       # enough for every n, and no more
    # no more than the rule's block target and one block a (row, KV head)
    assert budget <= WAVES * sms + rows * Hkv


@pytest.mark.parametrize("D", paged_decode.HEAD_DIMS)
@pytest.mark.parametrize("G", range(1, paged_decode.MAX_GROUP + 1))
def test_partial_records_hold_acc_m_l_at_16_bytes(G, D):
    stride = split_stride(G, D)
    assert stride % 4 == 0 and G * D + 2 * G <= stride < G * D + 2 * G + 4
