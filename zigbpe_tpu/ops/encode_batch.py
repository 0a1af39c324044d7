"""Batched padded-sequence encode — the serving-path API.

The reference encodes one global byte sequence at a time
(basic_tokenizer.zig:71-88). For throughput serving (BASELINE.json config
3: "apply frozen merge table to 1GB corpus, batched padded sequences") the
input is a [B, L] batch of PAD-padded rows. Rows are independent streams,
so every merge op of ops.core applies to the whole batch at once along the
last axis (compaction is a per-row stable sort).

The merge table is first list-scheduled into simultaneous chain-free groups
(:func:`schedule_merges`); each group is one ``merge_pass_multi`` over the
batch, so a 1,024-merge table replays in a few dozen passes instead of
1,024. On an H100 this replays 8,192 rows of 32,768 tokens 15x faster than
one pass per merge (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import core
from .core import PAD


def pad_batch(docs, length: int | None = None):
    """Host->device: list of byte strings -> (int32[B, L] PAD-padded,
    int32[B] lengths)."""
    B = len(docs)
    L = length or max((len(d) for d in docs), default=1)
    buf = np.full((B, max(L, 1)), PAD, dtype=np.int32)
    lens = np.zeros((B,), dtype=np.int32)
    for i, d in enumerate(docs):
        if len(d) > buf.shape[1]:
            raise ValueError(f"doc {i} length {len(d)} exceeds row length {buf.shape[1]}")
        buf[i, : len(d)] = np.frombuffer(bytes(d), dtype=np.uint8)
        lens[i] = len(d)
    return jnp.asarray(buf), jnp.asarray(lens)


def schedule_merges(merges, cap: int = 32):
    """Host-side: schedule the merge table into simultaneous chain-free
    groups over its independence DAG, in O(n) time.

    Two merges are independent iff their pairs are distinct, no token is
    chained across them (b_i == a_j or b_j == a_i), neither references the
    other's minted token, and — when either has a == b (overlap parity) —
    their token sets are fully disjoint. Independent merges COMMUTE: each
    one's candidate set on any stream is invariant under the other's
    application (destroying a candidate would need a member token consumed,
    which forces one of the excluded equalities; every created adjacency
    involves the minted token, which is never referenced). Hence replaying
    any topological linear extension of the dependency DAG — reachable
    from training order by adjacent transpositions of independent pairs —
    produces the same output for EVERY input, and pairwise-independent
    entries within one step may apply simultaneously (the group contract of
    ops.core.merge_pass_multi).

    The schedule is the DAG's ASAP layering: an entry's level is one more
    than the deepest earlier entry it interacts with. Every interaction
    shares a token value, so per-(role, token) maxima of the levels seen so
    far give each level in O(1). Two entries of one level never interact
    (the later one would sit deeper), so a level may apply at once, and
    replaying level by level is a topological order. Each level is cut into
    groups of at most ``cap``; a parity merge (a == b) can only take slot 0
    (merge_pass_multi runs the parity scan there), so each opens its own
    group.

    Returns (gtable int32[P, cap, 3] PAD-filled, glens int32[P]).
    """
    t = np.asarray(merges, np.int64).reshape(-1, 3)
    deepest = {}  # (role, token...) -> deepest level of an entry holding it

    def at(*key):
        return deepest.get(key, -1)

    def raise_to(level, *key):
        if deepest.get(key, -1) < level:
            deepest[key] = level

    levels = []
    for a, b, x in t.tolist():
        parity = a == b
        level = 1 + max(
            at("b", a), at("a", b),                 # chained
            at("x", a), at("x", b), at("x", x),     # references a minted token
            at("a", x), at("b", x),                 # its minted token is referenced
            at("pair", a, b),                       # same pair
            at("parity", a), at("parity", b), at("parity", x),
            *((at("any", a), at("any", x)) if parity else ()),
        )
        levels.append(level)
        for key in (("a", a), ("b", b), ("x", x), ("pair", a, b),
                    ("any", a), ("any", b), ("any", x)):
            raise_to(level, *key)
        if parity:
            raise_to(level, "parity", a)
            raise_to(level, "parity", x)

    groups = []
    by_level = {}
    for j, level in enumerate(levels):
        by_level.setdefault(level, []).append(j)
    for level in sorted(by_level):
        members = by_level[level]
        parity = [j for j in members if t[j, 0] == t[j, 1]]
        rest = [j for j in members if t[j, 0] != t[j, 1]]
        for p in parity:
            groups.append([p] + rest[: cap - 1])
            rest = rest[cap - 1 :]
        groups += [rest[i : i + cap] for i in range(0, len(rest), cap)]
    gtable = np.full((len(groups), cap, 3), PAD, np.int32)
    for p, g in enumerate(groups):
        gtable[p, : len(g)] = t[g]
    return gtable, np.asarray([len(g) for g in groups], np.int32)


def encode_batch(tokens: jax.Array, gtable: jax.Array):
    """Replay a scheduled merge table (schedule_merges' gtable, (P, cap, 3))
    over a [B, L] batch: one merge_pass_multi per group. PAD slots are
    no-ops. Returns (tokens, lengths) with rows prefix-compacted."""

    def step(toks, group):
        return core.merge_pass_multi(toks, group)[0], None

    toks, _ = jax.lax.scan(step, tokens, gtable)
    return toks, jnp.sum((toks >= 0).astype(jnp.int32), axis=1)
