"""Adversarial merge-table fuzz for the scheduled batched encode.

schedule_merges' commuting argument (ops/encode_batch.py) and
merge_pass_multi's group contract (ops/core.py) are subtle: a wrong
independence predicate silently corrupts the serving path. This fuzz
drives RANDOM merge tables — duplicate pairs, a == b members, references
to minted tokens, b -> a chains, re-minted ids, out-of-range ids up to the
u16 cap — over random docs through schedule_merges + encode_batch
and checks every row against the oracle's sequential replay
(basic_tokenizer.zig:71-88 semantics).
"""

import numpy as np
import pytest

from zigbpe_tpu.models import oracle
from zigbpe_tpu.ops import encode_batch as eb


def _adversarial_table(rng, n_merges):
    """Tables biased toward the predicate's hard cases: tiny alphabet so
    pairs repeat, minted tokens fed straight back in as a and b, chains
    (b_i == a_j), a == b doubling merges, ids minted twice, and the
    occasional far-out-of-range id."""
    alphabet = [97, 98, 99, 100]
    minted = []
    table = []
    next_new = 256
    for _ in range(n_merges):
        pool = alphabet + minted
        r = rng.random()
        if r < 0.15 and minted:
            a = b = int(rng.choice(minted))  # minted doubling (a == b)
        elif r < 0.3:
            a = b = int(rng.choice(alphabet))
        else:
            a = int(rng.choice(pool))
            b = int(rng.choice(pool))
        r2 = rng.random()
        if r2 < 0.08:
            x = int(rng.choice([9000, 40000, 65535]))  # out of mintable range
        elif r2 < 0.16 and minted:
            x = int(rng.choice(minted))  # re-mint an existing id
        else:
            x = next_new
            next_new += 1
        minted.append(x)
        table.append((a, b, x))
    return table


def _docs(rng, k):
    out = []
    for _ in range(k):
        n = int(rng.integers(0, 600))
        out.append(bytes(rng.integers(97, 101, n, dtype=np.uint8)))
    # always include the degenerate rows
    out += [b"", b"a" * 37]
    return out


@pytest.mark.parametrize("seed", range(50))
def test_fuzz_grouped_encode_vs_oracle(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(1000 + seed)
    table = _adversarial_table(rng, int(rng.integers(1, 25)))
    docs = _docs(rng, 3)

    L = 1024
    buf = np.full((len(docs), L), -1, np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(d, np.uint8)

    # alternate schedule caps: tight caps split groups the DAG allows,
    # wide ones pack every ready independent entry together
    cap = [4, 8, 16, 32][seed % 4]
    # Pad the scheduled table to a FIXED group count so all seeds share one
    # compiled program per cap (padded groups are PAD rows: provable
    # no-ops), instead of one compilation per seed.
    gt, _ = eb.schedule_merges(np.asarray(table, np.int32), cap=cap)
    PMAX = 32
    assert gt.shape[0] <= PMAX
    gt_p = np.full((PMAX, cap, 3), -1, np.int32)
    gt_p[: gt.shape[0]] = gt
    out, lens = eb.encode_batch(jnp.asarray(buf), jnp.asarray(gt_p))
    out, lens = np.asarray(out), np.asarray(lens)
    for i, d in enumerate(docs):
        got = out[i, : lens[i]].tolist()
        want = oracle.encode(d, table)
        assert got == want, (
            f"seed {seed} doc {i} cap {cap}: encode diverges from oracle for "
            f"table {table}"
        )
