"""Device op unit tests: each core op against hand vectors and the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from zigbpe_tpu.models import oracle
from zigbpe_tpu.ops import core


def toks(seq, capacity=None):
    arr, _ = core.pad_tokens(bytes(seq) if isinstance(seq, (bytes, bytearray)) else bytes(seq), capacity or max(len(seq), 8))
    return arr


def as_list(arr):
    a = np.asarray(arr)
    return a[a >= 0].tolist()


def test_pad_tokens():
    arr, n = core.pad_tokens(b"hello world", 16)
    assert int(n) == 11
    assert as_list(arr) == [ord(c) for c in "hello world"]
    assert np.asarray(arr)[11:].tolist() == [core.PAD] * 5


def test_pair_histogram_overlaps():
    # "aaa" counts (a,a) twice (SURVEY §2.3.2)
    a = ord("a")
    arr = toks(b"aaa")
    hist = core.pair_histogram(arr, 300)
    assert int(hist[a * 300 + a]) == 2
    assert int(jnp.sum(hist)) == 2


def test_pair_histogram_matches_oracle():
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    arr = toks(data, 512)
    hist = np.asarray(core.pair_histogram(arr, 300))
    want = oracle.count_pairs(list(data))
    got = {divmod(i, 300): int(c) for i, c in enumerate(hist) if c}
    assert got == dict(want)


def test_select_top_pair_tie_break():
    V = 300
    hist = jnp.zeros((V * V,), jnp.int32)
    hist = hist.at[5 * V + 7].set(9).at[200 * V + 3].set(9).at[1 * V + 1].set(4)
    ta, tb, cnt = core.select_top_pair(hist, V)
    # tie at count 9: larger (first, second) wins -> (200, 3)
    assert (int(ta), int(tb), int(cnt)) == (200, 3, 9)


def test_select_empty():
    _, _, cnt = core.select_top_pair(jnp.zeros((300 * 300,), jnp.int32), 300)
    assert int(cnt) == 0


def test_select_top_pair_sorted_matches_histogram_path():
    rng = np.random.default_rng(3)
    V = 300
    for seed_lo, seed_hi, n in [(97, 100, 500), (0, 256, 1000), (97, 99, 64)]:
        data = bytes(rng.integers(seed_lo, seed_hi, n, dtype=np.uint8))
        arr = toks(data, max(8, 1 << (n - 1).bit_length()))
        ha, hb, hc = core.select_top_pair(core.pair_histogram(arr, V), V)
        sa, sb, sc = core.select_top_pair_sorted(arr, V)
        assert (int(ha), int(hb), int(hc)) == (int(sa), int(sb), int(sc))


def test_select_top_pair_sorted_huge_vocab_no_overflow():
    # a*V+b would overflow int32 at V=65536; the two-key sort must not
    V = 65536
    arr = toks(b"hello world hello", 32)
    ta, tb, cnt = core.select_top_pair_sorted(arr, V)
    # count-2 tie resolves to the lexicographically largest pair: ('l','o')
    assert (int(ta), int(tb), int(cnt)) == (ord("l"), ord("o"), 2)


def test_train_chunk_sorted_path_huge_vocab():
    data = b"hello world hello hello"
    V = 65535
    arr, n = core.pad_tokens(data, 32)
    merges = jnp.full((8, 3), core.PAD, jnp.int32)
    occ = jnp.zeros((8,), jnp.int32)
    _, _, merges, _, k = core.train_chunk(
        arr, n, merges, occ, jnp.int32(0), vocab_size=V, max_rounds=8
    )
    got = [tuple(r) for r in np.asarray(merges[: int(k)]).tolist()]
    assert got == oracle.train(data, 256 + 8)


def test_select_top_pair_sorted_empty_and_tiny():
    V = 300
    arr = jnp.full((8,), core.PAD, jnp.int32)
    _, _, cnt = core.select_top_pair_sorted(arr, V)
    assert int(cnt) == 0  # no pairs -> early-stop signal
    one = arr.at[0].set(97)
    _, _, cnt = core.select_top_pair_sorted(one, V)
    assert int(cnt) == 0  # single token has no pair
    two = one.at[1].set(98)
    ta, tb, cnt = core.select_top_pair_sorted(two, V)
    assert (int(ta), int(tb), int(cnt)) == (97, 98, 1)


@pytest.mark.parametrize(
    "text,pair,expect",
    [
        (b"aaa", (97, 97), [256, 97]),
        (b"aaaa", (97, 97), [256, 256]),
        (b"aaaaa", (97, 97), [256, 256, 97]),
        (b"abab", (97, 98), [256, 256]),
        (b"xay", (97, 98), [120, 97, 121]),
        (b"ab", (97, 98), [256]),
    ],
)
def test_merge_pass_greedy(text, pair, expect):
    arr = toks(text)
    out, nhits = core.merge_pass(arr, pair[0], pair[1], 256)
    assert as_list(out) == expect
    # cross-check against oracle
    assert as_list(out) == oracle.merge_pass(list(text), pair[0], pair[1], 256)


def test_merge_pass_random_vs_oracle():
    rng = np.random.default_rng(1)
    # low-entropy corpus to force overlapping runs
    data = bytes(rng.integers(97, 100, 2000, dtype=np.uint8))
    arr = toks(data, 2048)
    for pair in [(97, 97), (97, 98), (98, 97), (99, 99)]:
        out, _ = core.merge_pass(arr, pair[0], pair[1], 256)
        assert as_list(out) == oracle.merge_pass(list(data), pair[0], pair[1], 256)


def test_train_chunk_matches_oracle():
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(97, 103, 4000, dtype=np.uint8))
    V = 280
    arr, n = core.pad_tokens(data, 4096)
    merges = jnp.full((V - 256, 3), core.PAD, jnp.int32)
    occ = jnp.zeros((V - 256,), jnp.int32)
    toks_out, length, merges, occ, k = core.train_chunk(
        arr, n, merges, occ, jnp.int32(0), vocab_size=V, max_rounds=V - 256
    )
    want = oracle.train(data, V)
    got = [tuple(r) for r in np.asarray(merges[: int(k)]).tolist()]
    assert got == want
    # final token stream matches oracle encode of the corpus
    assert as_list(toks_out) == oracle.encode(data, want)
    assert int(length) == len(oracle.encode(data, want))


def test_count_pair():
    rng = np.random.default_rng(4)
    data = bytes(rng.integers(97, 101, 3000, dtype=np.uint8))
    V = 300
    arr = toks(data, 4096)
    hist = np.asarray(core.pair_histogram(arr, V)).reshape(V, V)
    for a, b in [(97, 98), (98, 97), (100, 100), (1, 2)]:
        assert int(core.count_pair(arr, a, b)) == hist[a, b]


def test_select_top_pair_lazy_matches_sorted():
    rng = np.random.default_rng(5)
    V = 300
    data = bytes(rng.integers(97, 103, 2000, dtype=np.uint8))
    arr = toks(data, 2048)
    ub = core.pair_histogram(arr, V)
    # exact ub: one pop, same answer as the sort path
    sa, sb, sc = core.select_top_pair_sorted(arr, V)
    la, lb, lc, _, _ = core.select_top_pair_lazy(ub, arr, V)
    assert (int(la), int(lb), int(lc)) == (int(sa), int(sb), int(sc))
    # stale ub (inflated counts elsewhere): pops must still find the truth
    stale = ub.at[5 * V + 7].set(10**6).at[200 * V + 3].set(10**6)
    la, lb, lc, ub2, rm2 = core.select_top_pair_lazy(stale, arr, V)
    assert (int(la), int(lb), int(lc)) == (int(sa), int(sb), int(sc))
    # the popped stale bins were corrected to exact values
    assert int(ub2[5 * V + 7]) == int(core.count_pair(arr, 5, 7))
    assert int(ub2[200 * V + 3]) == int(core.count_pair(arr, 200, 3))
    # the returned row cache is the exact per-row max of the returned table
    assert np.asarray(rm2).tolist() == np.asarray(
        core.rowmax_of(ub2, V)
    ).tolist()
    # a caller-supplied stale-but-sound rowmax (entries only ever
    # overestimate) must still converge to the same answer
    rm_stale = core.rowmax_of(stale, V)
    la, lb, lc, _, _ = core.select_top_pair_lazy(
        stale, arr, V, rowmax=rm_stale
    )
    assert (int(la), int(lb), int(lc)) == (int(sa), int(sb), int(sc))
    # genuinely INFLATED rowmax entries (no matching column in the row):
    # the pop must fall back to the row's true argmax, never wrap b=-1
    rm_inflated = rm_stale.at[17].set(10**6).at[int(sa)].set(10**6)
    la, lb, lc, ub3, rm3 = core.select_top_pair_lazy(
        stale, arr, V, rowmax=rm_inflated
    )
    assert (int(la), int(lb), int(lc)) == (int(sa), int(sb), int(sc))
    # no bin was corrupted by a wrapped write: the table is still a sound
    # upper bound everywhere, and the returned row cache is exact
    hist2 = np.asarray(core.pair_histogram(arr, V)).reshape(V, V)
    assert (np.asarray(ub3).reshape(V, V) >= hist2).all()
    assert np.asarray(rm3).tolist() == np.asarray(
        core.rowmax_of(ub3, V)
    ).tolist()


def test_train_chunk_lazy_matches_oracle():
    rng = np.random.default_rng(6)
    data = bytes(rng.integers(97, 103, 4000, dtype=np.uint8))
    V = 280
    arr, n = core.pad_tokens(data, 4096)
    ub = core.pair_histogram(arr, V)
    merges = jnp.full((V - 256, 3), core.PAD, jnp.int32)
    occ = jnp.zeros((V - 256,), jnp.int32)
    toks_out, length, ub, merges, occ, k = core.train_chunk_lazy(
        arr, n, ub, merges, occ, jnp.int32(0), vocab_size=V, max_rounds=V - 256
    )
    want = oracle.train(data, V)
    got = [tuple(r) for r in np.asarray(merges[: int(k)]).tolist()]
    assert got == want
    assert as_list(toks_out) == oracle.encode(data, want)
    assert int(length) == len(oracle.encode(data, want))


def test_encode_replay_matches_oracle():
    data = b"hello world hello hello world"
    merges = oracle.train(data, 300)
    marr = jnp.asarray(np.asarray(merges, dtype=np.int32))
    arr = toks(b"hello world", 32)
    out, length = core.encode_replay(arr, marr)
    assert as_list(out) == oracle.encode(b"hello world", merges)
    assert int(length) == len(oracle.encode(b"hello world", merges))


def test_encode_replay_pad_rows_noop():
    merges = np.full((8, 3), core.PAD, dtype=np.int32)
    merges[0] = [ord("h"), ord("e"), 256]
    arr = toks(b"hehe", 8)
    out, length = core.encode_replay(arr, jnp.asarray(merges))
    assert as_list(out) == [256, 256]
    assert int(length) == 2
