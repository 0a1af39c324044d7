"""Batched padded-sequence encode: per-row agreement with the oracle."""

import numpy as np
import pytest

from zigbpe_tpu import BasicTokenizer
from zigbpe_tpu.models import oracle


@pytest.fixture(scope="module")
def trained():
    data = b"hello world hello the quick brown fox hello " * 30
    return oracle.train(data, 320), data


def test_encode_batch_matches_oracle(trained):
    merges, data = trained
    tok = BasicTokenizer(merges)
    docs = [b"hello world", b"the quick brown fox", b"", b"h", b"hello hello hello"]
    got = tok.encode_batch(docs)
    for d, ids in zip(docs, got):
        assert ids == oracle.encode(d, merges), d


def test_encode_batch_overlap_runs(trained):
    merges, _ = trained
    tok = BasicTokenizer([(97, 97, 256), (256, 256, 257)])
    docs = [b"aaa", b"aaaa", b"aaaaa", b"aaaaaaaa"]
    got = tok.encode_batch(docs)
    for d, ids in zip(docs, got):
        assert ids == oracle.encode(d, tok.merges), d


def test_encode_batch_equals_single(trained):
    merges, data = trained
    tok = BasicTokenizer(merges)
    docs = [data[i * 100 : (i + 1) * 100] for i in range(10)]
    batch = tok.encode_batch(docs)
    single = [tok.encode(d, backend="device") for d in docs]
    assert batch == single


def test_encode_batch_empty():
    assert BasicTokenizer([(97, 98, 256)]).encode_batch([]) == []


def test_encode_batch_no_merges():
    assert BasicTokenizer().encode_batch([b"ab"]) == [[97, 98]]


# --- the device formulation itself (ops.encode_batch: scheduled groups,
# one merge_pass_multi per group) against the oracle's sequential replay


def _run(docs, merges, L=1024):
    import jax.numpy as jnp

    from zigbpe_tpu.ops import encode_batch as eb

    gtable, _ = eb.schedule_merges(np.asarray(merges, np.int32).reshape(-1, 3))
    tokens, _ = eb.pad_batch(docs, L)
    out, lens = eb.encode_batch(tokens, jnp.asarray(gtable))
    out, lens = np.asarray(out), np.asarray(lens)
    return [out[i, : lens[i]].tolist() for i in range(len(docs))]


def test_rows_match_oracle_trained_table():
    rng = np.random.default_rng(21)
    data = bytes(rng.integers(97, 104, 4000, dtype=np.uint8))
    merges = oracle.train(data, 300)
    docs = [
        bytes(rng.integers(97, 104, int(rng.integers(1, 900)), dtype=np.uint8))
        for _ in range(4)
    ]
    docs += [b"", b"a", b"aaaaaaa"]  # empty row, 1-byte row, parity run
    for d, g in zip(docs, _run(docs, merges)):
        assert g == oracle.encode(d, merges)


def test_rows_independent():
    # the same doc encodes identically regardless of its batch neighbours
    merges = [(97, 97, 256), (256, 97, 257), (98, 99, 258)]
    a = _run([b"aaaab bc", b"zzz"], merges)
    b = _run([b"aaaab bc", b"aaaa", b"bcbcbc"], merges)
    assert a[0] == b[0] == oracle.encode(b"aaaab bc", merges)


def test_row_collapsing_to_one_token():
    merges = [(97, 97, 256), (256, 256, 257), (257, 257, 258)]
    got = _run([b"a" * 8], merges)
    assert got[0] == oracle.encode(b"a" * 8, merges)


def test_out_of_range_ids():
    # a malformed table minting an id far beyond 256+M must still replay
    merges = [(97, 98, 9000), (9000, 99, 257)]
    got = _run([b"abcabc"], merges)
    assert got[0] == oracle.encode(b"abcabc", merges)


def test_pad_rows_in_table_are_noops():
    merges = [(97, 98, 256), (-1, -1, -1), (256, 99, 257)]
    got = _run([b"abcabc"], merges)
    want = oracle.encode(b"abcabc", [(97, 98, 256), (256, 99, 257)])
    assert got[0] == want


def test_empty_merge_table():
    # no groups: the scan has zero steps and the rows come back unchanged
    got = _run([b"abcabc", b""], np.zeros((0, 3), np.int32))
    assert got == [[97, 98, 99, 97, 98, 99], []]


def test_golden_table_on_corpus_rows(corpus_bytes, golden_merges):
    docs = [corpus_bytes[i * 1024 : (i + 1) * 1024] for i in range(8)]
    for d, g in zip(docs, _run(docs, golden_merges)):
        assert g == oracle.encode(d, golden_merges)


def _interact(p, q):
    """The dependency predicate schedule_merges' docstring states, written
    out pair by pair."""
    (ai, bi, xi), (aj, bj, xj) = p, q
    if (ai, bi) == (aj, bj) or xi in (aj, bj, xj) or xj in (ai, bi):
        return True
    if bi == aj or bj == ai:
        return True
    if ai == bi or aj == bj:
        return bool({ai, bi, xi} & {aj, bj, xj})
    return False


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_schedule_is_a_valid_group_order(seed, golden_merges):
    """Every group is pairwise independent with at most one a == b entry,
    in slot 0; every entry comes after each earlier entry it interacts
    with; and the groups hold the table exactly once."""
    from zigbpe_tpu.ops import encode_batch as eb

    if seed is None:
        table = [tuple(m) for m in golden_merges]
    else:
        rng = np.random.default_rng(seed)
        pool = [97, 98, 99] + list(range(256, 262))
        table = [(int(rng.choice(pool)), int(rng.choice(pool)), 256 + i)
                 for i in range(60)]
    cap = 4
    gtable, glens = eb.schedule_merges(np.asarray(table, np.int32), cap=cap)
    assert gtable.shape == (len(glens), cap, 3)
    where = {}
    for p, n in enumerate(glens):
        group = [tuple(int(v) for v in row) for row in gtable[p, :n]]
        assert (gtable[p, n:] == -1).all()
        for s, e in enumerate(group):
            assert e[0] != e[1] or s == 0
            assert not any(_interact(e, f) for f in group[s + 1:])
            where.setdefault(e, []).append(p)
    assert sorted(where) == sorted(set(table))
    assert sum(glens) == len(table)
    for j, e in enumerate(table):
        for i in range(j):
            if _interact(table[i], e) and table[i] != e:
                assert max(where[table[i]]) < min(where[e]), (table[i], e)


def test_schedule_parity_entry_leads_its_level():
    # an a == b merge shares a group with independent entries, in slot 0
    from zigbpe_tpu.ops import encode_batch as eb

    gtable, glens = eb.schedule_merges(
        np.asarray([(98, 99, 256), (97, 97, 257), (100, 101, 258)], np.int32)
    )
    assert glens.tolist() == [3]
    assert gtable[0, 0].tolist() == [97, 97, 257]
    got = _run([b"aaabcdeaa"], [(98, 99, 256), (97, 97, 257), (100, 101, 258)])
    assert got[0] == oracle.encode(
        b"aaabcdeaa", [(98, 99, 256), (97, 97, 257), (100, 101, 258)]
    )
