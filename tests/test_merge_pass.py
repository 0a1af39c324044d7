"""Greedy merge pass + compaction (ops.core.merge_pass / merge_pass_multi)
against the oracle's sequential replay (basic_tokenizer.zig:207-232
semantics): small vectors, a==b runs, long runs, heavy compaction,
multi-slot groups and disabled slots, on one stream and on a batch of
rows."""

import jax.numpy as jnp
import numpy as np
import pytest

from zigbpe_tpu.models import oracle
from zigbpe_tpu.ops import core

rng = np.random.default_rng(0)


def _valid(arr) -> list:
    """Valid tokens of a prefix-compacted stream; asserts the prefix
    invariant (valid tokens first, PAD tail)."""
    arr = np.asarray(arr)
    n = int((arr >= 0).sum())
    assert (arr[:n] >= 0).all() and (arr[n:] < 0).all(), "not a valid prefix"
    return arr[:n].tolist()


def _check(data: bytes, a: int, b: int, cap: int):
    arr, _ = core.pad_tokens(data, cap)
    got, nhits = core.merge_pass(arr, a, b, 256)
    want = oracle.merge_pass(list(data), a, b, 256)
    assert _valid(got) == want
    assert int(nhits) == len(data) - len(want)


@pytest.mark.parametrize(
    "data,pair",
    [
        (b"aaa", (97, 97)),          # overlap run: aaa -> [X, a]
        (b"aaaa", (97, 97)),
        (b"abab", (97, 98)),
        (b"xay", (97, 98)),          # no hits
        (b"", (97, 98)),             # empty corpus
        (b"a", (97, 97)),            # single byte, no pair
    ],
)
def test_small_vectors(data, pair):
    _check(data, pair[0], pair[1], 1024)


@pytest.mark.parametrize("pair", [(97, 98), (97, 97)])
def test_random_short_stream(pair):
    data = bytes(rng.integers(97, 100, 900, dtype=np.uint8))
    _check(data, pair[0], pair[1], 1024)


@pytest.mark.parametrize("pair", [(97, 98), (97, 97)])
def test_random_long_stream(pair):
    data = bytes(rng.integers(97, 100, 4000, dtype=np.uint8))
    _check(data, pair[0], pair[1], 4096)


def test_candidate_run_spanning_stream():
    # one unbroken a-run across most of the stream: the greedy parity
    # scan must hold from the run start to its end
    _check(b"a" * 3000, 97, 97, 4096)


def test_pair_at_power_of_two_offset():
    data = bytearray(rng.integers(99, 103, 4096, dtype=np.uint8))
    data[1023] = 97
    data[1024] = 98
    _check(bytes(data), 97, 98, 4096)


def test_heavy_compaction():
    # every other slot dies: the compaction moves almost every token
    _check(b"ab" * 2000, 97, 98, 4096)


def _multi_check(data, table, cap):
    """merge_pass_multi vs sequential oracle replay of the table's slots."""
    arr, _ = core.pad_tokens(data, cap)
    t = jnp.asarray(np.asarray(table, np.int32).reshape(-1, 3))
    got, nhits = core.merge_pass_multi(arr, t)
    stream = list(data)
    for a, b, x in table:
        if x >= 0 and a >= 0:
            stream = oracle.merge_pass(stream, a, b, x)
    assert _valid(got) == stream
    assert int(jnp.sum(nhits)) == len(data) - len(stream)
    return np.asarray(nhits)


def test_multi_two_disjoint_pairs():
    nhits = _multi_check(b"abcdabcdxy", [(97, 98, 256), (99, 100, 257)], 1024)
    assert nhits.tolist() == [2, 2]


def test_multi_shared_left_tokens():
    # a_i == a_j and b_i == b_j are both allowed by the group contract
    _multi_check(b"ab ac ab ac", [(97, 98, 256), (97, 99, 257)], 1024)
    _multi_check(b"xa ya xa", [(120, 97, 256), (121, 97, 257)], 1024)


def test_multi_disabled_slots():
    nhits = _multi_check(
        b"abab", [(97, 98, 256), (-2, -2, -2), (-1, -1, -1)], 1024
    )
    assert nhits.tolist() == [2, 0, 0]


def test_multi_parity_slot0_with_disjoint_member():
    # slot 0 may be a == b (overlap parity); the second member shares no
    # token with it
    nhits = _multi_check(b"aaaxyxy", [(97, 97, 256), (120, 121, 257)], 1024)
    assert nhits.tolist() == [1, 2]  # aaa -> [X, a]


def test_multi_far_apart_hits():
    data = bytearray(rng.integers(101, 104, 4096, dtype=np.uint8))
    data[1023] = 97
    data[1024] = 98
    data[2047] = 99
    data[2048] = 100
    _multi_check(bytes(data), [(97, 98, 256), (99, 100, 257)], 4096)


def test_multi_random_groups_vs_oracle():
    # random chain-free groups over random data (the group contract the
    # selection layer guarantees)
    for seed in range(10):
        r = np.random.default_rng(seed)
        data = bytes(r.integers(97, 105, 3000, dtype=np.uint8))
        toks = list(range(97, 105))
        r.shuffle(toks)
        # 4 disjoint-token pairs are trivially chain-free and distinct
        table = [(toks[2 * i], toks[2 * i + 1], 256 + i) for i in range(4)]
        _multi_check(data, table, 4096)


def _rows(docs, L):
    buf = np.full((len(docs), L), core.PAD, np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(d, np.uint8)
    return jnp.asarray(buf)


@pytest.mark.parametrize("pair", [(97, 97), (97, 98)])
def test_batched_rows_merge_independently(pair):
    # a (B, L) batch merges along the last axis: no pair and no parity run
    # crosses a row boundary
    docs = [b"a" * 63, b"ab" * 30, b"", b"ba" * 31 + b"a",
            bytes(rng.integers(97, 99, 64, dtype=np.uint8))]
    got, nhits = core.merge_pass(_rows(docs, 64), pair[0], pair[1], 256)
    want = [oracle.merge_pass(list(d), pair[0], pair[1], 256) for d in docs]
    assert [_valid(r) for r in np.asarray(got)] == want
    assert int(nhits) == sum(len(d) for d in docs) - sum(map(len, want))


def test_batched_rows_multi():
    docs = [b"abcdab", b"cdcdcd", b"aaaa", b""]
    table = [(97, 97, 256), (99, 100, 257)]
    got, _ = core.merge_pass_multi(
        _rows(docs, 8), jnp.asarray(np.asarray(table, np.int32))
    )
    want = [oracle.encode(d, table) for d in docs]
    assert [_valid(r) for r in np.asarray(got)] == want
