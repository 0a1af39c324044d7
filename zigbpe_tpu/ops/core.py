"""Core device ops for BPE training and encoding, in plain jax.numpy/lax.

Design notes:

* Primary top-pair selection = **lazy upper bounds + batch verification**
  (select_top_pair_lazy + train_chunk_lazy): no per-round histogram or
  sort at all; typically one masked corpus reduction per round. The
  sort+segment-scan path (select_top_pair_sorted) is the fallback for
  vocab sizes past the dense-ub limit, and the dense histogram
  (pair_histogram + select_top_pair) initialises ub and serves small
  utilities/tests. All three implement the same tie-break (largest
  (first, second) wins, reproducing the reference's single golden tie,
  SURVEY.md §2.3.3).
* Leftmost-greedy overlap resolution (basic_tokenizer.zig:207-232) is a
  ``cummax`` parity scan: a run of candidate pairs only occurs when
  first==second, and greedy selects every other candidate from the run
  start. ``aaa`` + (a,a)->X  =>  [X, a].
* Compaction = two-operand **stable sort** on a 0/1 dead key. Valid tokens
  always form a *prefix*; the tail is PAD (-1). This formulation was
  chosen on other hardware and is untuned on the GPU; its cost per pass is
  what PERF.md tracks.

The merge ops (greedy_hits, merge_pass, merge_pass_multi) work along the
LAST axis, so the same code merges one stream (N,) or a batch of
independent rows (B, L).

All functions are pure, fixed-shape, and jit/scan/while_loop friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PAD = -1
VOCAB_START = 256


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("capacity",))
def _unpack_bytes(words: jax.Array, n, *, capacity: int):
    """Device-side: (rows, 32) packed words -> PAD-tailed int32[capacity].

    The host packs row-transposed (pad_tokens), so unpacking is a concat
    of four shifted (rows, 32) views into (rows, 128) — no per-word
    interleave is materialized."""
    u0 = words & 0xFF
    u1 = (words >> 8) & 0xFF
    u2 = (words >> 16) & 0xFF
    u3 = (words >> 24) & 0xFF
    toks = jnp.concatenate([u0, u1, u2, u3], axis=1).reshape(-1)
    idx = jnp.arange(capacity, dtype=jnp.int32)
    return jnp.where(idx < n, toks, PAD)


def pad_tokens(byte_array, capacity: int):
    """Host->device: place byte tokens in a PAD-tailed int32 array of
    static ``capacity`` (byte-level init, basic_tokenizer.zig:155-170).

    The corpus crosses the host->device link PACKED, 4 bytes per int32,
    so the transfer moves one byte per corpus byte rather than the four
    of materialized int32 tokens. The host packs each 128-byte row
    transposed — word w of a row holds bytes (w, w+32, w+64, w+96) — so
    the device unpack is a plain concat (see _unpack_bytes). PAD-masking
    runs on device. Whether a plain uint8 put plus a device cast is as
    fast on the GPU is not measured."""
    import numpy as np

    data = bytes(byte_array)
    n = len(data)
    if n > capacity:
        raise ValueError(f"corpus length {n} exceeds capacity {capacity}")
    if capacity % 128:
        # tiny capacities: upload int32 tokens directly (packing needs
        # 128-byte rows; the wire saving is irrelevant at this size)
        buf = np.full((capacity,), PAD, dtype=np.int32)
        buf[:n] = np.frombuffer(data, dtype=np.uint8)
        return jnp.asarray(buf), jnp.int32(n)
    buf = np.zeros((capacity,), dtype=np.uint8)
    buf[:n] = np.frombuffer(data, dtype=np.uint8)
    b = buf.reshape(-1, 4, 32).astype(np.uint32)
    words = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)).astype(
        np.int32
    )  # (rows, 32)
    return _unpack_bytes(jnp.asarray(words), jnp.int32(n), capacity=capacity), jnp.int32(n)


def pad_token_ids(ids, capacity: int):
    """Host->device: place an int32 token-id stream (e.g. from a resumed
    checkpoint) in a PAD-tailed array of static ``capacity``."""
    import numpy as np

    ids = np.asarray(ids, dtype=np.int32)
    if ids.size > capacity:
        raise ValueError(f"token stream {ids.size} exceeds capacity {capacity}")
    buf = np.full((capacity,), PAD, dtype=np.int32)
    buf[: ids.size] = ids
    return jnp.asarray(buf), jnp.int32(ids.size)


def pair_streams(tokens: jax.Array):
    """(a, b) where b[j] is the token after position j (PAD if none) — the
    adjacent-pair view of a PAD-tailed prefix stream behind every counting
    and selection op."""
    return tokens, _next_tokens(tokens)


def pair_histogram(tokens: jax.Array, vocab_size: int) -> jax.Array:
    """Dense ``V*V`` histogram of adjacent pairs, overlaps included
    (reference semantics: basic_tokenizer.zig:234-278).

    Pairs involving PAD (including the final-position wraparound) scatter
    out of range and drop.
    """
    V = vocab_size
    a, b = pair_streams(tokens)
    valid = b >= 0  # prefix property: a >= 0 wherever b >= 0
    pid = jnp.where(valid, a * V + b, V * V)
    return jnp.zeros((V * V,), jnp.int32).at[pid].add(1, mode="drop")


def select_top_pair(hist: jax.Array, vocab_size: int):
    """Argmax pair with deterministic tie-break: on equal counts the larger
    pair-id (== lexicographically larger (first, second)) wins.

    Returns (first, second, count). count==0 means no pairs exist
    (the reference's early-stop condition, basic_tokenizer.zig:188-191).
    """
    V = vocab_size
    max_count = jnp.max(hist)
    ids = jax.lax.broadcasted_iota(jnp.int32, hist.shape, 0)
    top = jnp.max(jnp.where(hist == max_count, ids, -1))
    return top // V, top % V, max_count


def select_top_pair_sorted(tokens: jax.Array, vocab_size: int):
    """Argmax pair straight from the token stream via sort + segment scan —
    no histogram is materialized, no scatter is issued.

    Sorting the pair ids groups equal pairs into runs; run lengths fall out
    of a cummax over run-start indices, and the argmax + tie-break (largest
    pair-id wins, SURVEY.md §2.3.3) is two reductions. A scatter-add
    histogram is the alternative; which is faster on the GPU is not
    measured.

    Same contract as select_top_pair: returns (first, second, count);
    count==0 means no pairs exist (basic_tokenizer.zig:188-191).

    Pairs are sorted as TWO keys (first, second) rather than a flattened
    pair id: ``a * V + b`` would overflow int32 for V > 46341, and the
    u16 vocab cap is 65536 (basic_tokenizer.zig:140).
    """
    a, b = pair_streams(tokens)
    valid = b >= 0
    # invalid pairs sort last (V is at most 2^16, so 2^17 beats any token)
    BIG = jnp.int32(1 << 17)
    ka = jnp.where(valid, a, BIG)
    kb = jnp.where(valid, b, BIG)
    sa, sb = jax.lax.sort((ka, kb), num_keys=2)
    n = sa.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    boundary = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])
    is_start = jnp.concatenate([jnp.ones((1,), bool), boundary])
    is_end = jnp.concatenate([boundary, jnp.ones((1,), bool)])
    start_idx = jax.lax.cummax(jnp.where(is_start, idx, -1))
    run_len = jnp.where(is_end & (sa < BIG), idx + 1 - start_idx, 0)
    maxlen = jnp.max(run_len)
    # tie-break: lexicographically largest (first, second) among max runs
    top_a = jnp.max(jnp.where(run_len == maxlen, sa, -1))
    top_b = jnp.max(jnp.where((run_len == maxlen) & (sa == top_a), sb, -1))
    return top_a, top_b, maxlen


def count_pair(tokens: jax.Array, first, second):
    """Exact count of adjacent pair (first, second) in the logical stream —
    one masked reduction (overlaps included, reference semantics
    basic_tokenizer.zig:234-278)."""
    a, b = pair_streams(tokens)
    return jnp.sum(((a == first) & (b == second) & (b >= 0)).astype(jnp.int32))


def rowmax_of(ub: jax.Array, vocab_size: int) -> jax.Array:
    """Exact per-row maximum of the flat V*V upper-bound table — the pop
    cache consumed by select_top_pair_lazy."""
    V = vocab_size
    return jnp.max(ub.reshape(V, V), axis=1)


def select_top_pair_lazy(ub: jax.Array, tokens: jax.Array, vocab_size: int,
                         batch: int = 8,
                         rowmax: jax.Array | None = None,
                         count_fn=None, hot=None, hot_batch: int = 4,
                         protect_from=None, return_verified: bool = False,
                         col_k: int = 2):
    """Lazy-heap argmax: pop the ``batch`` largest entries of the stale
    upper-bound table ``ub``, verify them ALL with one exact corpus pass,
    and repeat until the table's argmax is a verified entry. Returns
    (first, second, count, ub', rowmax').

    Soundness: every ub entry is >= the true live count (merging (a,b)->X
    only DECREASES counts of bins not involving X, and X bins are re-bounded
    each round), so once the argmax of ub is exact it is the true argmax.
    The argmax order (max count, then max first, then max second) realises
    the documented tie-break (SURVEY.md §2.3.3). Batching matters: a verify
    pass streams the whole corpus, so verifying the top-8 costs barely more
    than the top-1, and stale rounds need several corrections.

    ``rowmax`` is the exact per-row max of ub (rowmax_of). With it, each pop
    reads O(V) — argmax over rowmax picks the row, one row slice picks the
    column — instead of O(V^2) over the whole table; this is what keeps the
    per-round cost flat once the corpus has shrunk (the V^2 table would
    otherwise dominate: 8 pops x 2 full-table reductions = ~100 MB of HBM
    reads per round at vocab 1280). Computed from ub when not supplied.

    ``count_fn(pa, pb) -> int32[len(pa)]`` overrides the exact-count pass —
    the data-parallel trainer supplies a shard-local count + psum so the
    same pop machinery runs replicated over a mesh (parallel.train_dp).

    ``protect_from`` (traced scalar token id or None): bins whose row or
    column is >= this id keep their current ub value instead of the
    measured count. Used by multi-merge group building
    (train_chunk_lazy): the corpus pass counts the PRE-group stream, so a
    bin referencing a token minted earlier in the same group would be
    measured as 0 — an unsound underestimate. Keeping the (sound upper
    bound) value instead lets the loop terminate on such a bin, after
    which the group-acceptance check rejects it.

    ``hot`` (traced scalar, the previous round's new token id) folds the
    top-``hot_batch`` entries of row ``hot`` and column ``hot`` into every
    verify pass. The bounds written for a fresh token (update_ub_after_merge
    caps row b / column a at nhits) are systematically high, so at deep
    vocabs the pop/verify loop otherwise spends several iterations per
    round chasing them; eagerly verifying the hot row/col the round after
    it is minted usually collapses that to one iteration.
    """
    V = vocab_size
    u2 = ub.reshape(V, V)
    if rowmax is None:
        rowmax = jnp.max(u2, axis=1)
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (V,), 0)
    col_iota = row_iota
    hots = [] if hot is None else (hot if isinstance(hot, (list, tuple)) else [hot])
    nver = col_k * batch + 1 + 2 * hot_batch * len(hots)
    if count_fn is None:
        sa, sb = pair_streams(tokens)
        # verify compares against ONE packed stream when V*V fits int32 (one
        # corpus-sized read per verify iteration instead of two); component
        # compare past that (u16 cap is 65536 > 46341)
        packed = V * V < 2**31
        if packed:
            pid_stream = jnp.where(
                sb >= 0, sa.astype(jnp.int32) * V + sb, -1
            )
        else:
            svalid = sb >= 0

        def count_fn(pa, pb):
            if packed:
                return jnp.stack([
                    jnp.sum((pid_stream == pa[j] * V + pb[j]).astype(jnp.int32))
                    for j in range(pa.shape[0])
                ])
            return jnp.stack([
                jnp.sum(((sa == pa[j]) & (sb == pb[j]) & svalid).astype(jnp.int32))
                for j in range(pa.shape[0])
            ])

    def round_(state):
        u2, rm = state[0], state[1]
        # verify set: the top-`batch` rows by the row cache (one chain-free
        # lax.top_k instead of sequential masked argmaxes), then the top-2
        # entries of each selected row in one batched top_k. The verify SET
        # doesn't need exact pop order — only the final argmax check below
        # realises the tie-break — so cheap approximate popping is sound.
        _, rows_idx = jax.lax.top_k(rm, batch)
        rows_mat = jnp.concatenate(
            [jax.lax.dynamic_slice(u2, (rows_idx[j], 0), (1, V))
             for j in range(batch)], axis=0,
        )  # (batch, V)
        _, cols2 = jax.lax.top_k(rows_mat, col_k)
        pa_parts = [jnp.repeat(rows_idx, col_k)]
        pb_parts = [cols2.reshape(-1)]
        for h in hots:
            # eager hot-row/col pops: the freshest bounds are the stalest
            # (with merge groups, every token the previous round minted)
            hr = jnp.clip(jnp.asarray(h, jnp.int32), 0, V - 1)
            hrow = jax.lax.dynamic_slice(u2, (hr, 0), (1, V))[0]
            _, hcols = jax.lax.top_k(hrow, hot_batch)
            hcol = jax.lax.dynamic_slice(u2, (0, hr), (V, 1))[:, 0]
            _, hrows = jax.lax.top_k(hcol, hot_batch)
            pa_parts += [jnp.broadcast_to(hr, (hot_batch,)), hrows]
            pb_parts += [hcols, jnp.broadcast_to(hr, (hot_batch,))]
        # ALWAYS include the exact tie-break candidate (largest row among
        # max rows, largest col at the row max): top_k breaks ties by
        # SMALLEST index, so with 3+ tied entries the checked candidate
        # could otherwise never enter the verify set and the loop would
        # spin on already-exact values.
        c0m = jnp.max(rm)
        a0m = jnp.max(jnp.where(rm == c0m, row_iota, -1))
        row0m = jax.lax.dynamic_slice(u2, (a0m, 0), (1, V))[0]
        b0m = jnp.max(jnp.where(row0m == c0m, col_iota, -1))
        pa_parts += [a0m.reshape(1)]
        pb_parts += [jnp.maximum(b0m, 0).reshape(1)]
        pa = jnp.concatenate(pa_parts)
        pb = jnp.concatenate(pb_parts)
        # one corpus pass verifies all of them exactly (the masked
        # reductions over the same stream fuse into one traversal)
        exact = count_fn(pa, pb)
        if protect_from is not None:
            cur = jnp.stack([
                jax.lax.dynamic_slice(u2, (pa[j], pb[j]), (1, 1))[0, 0]
                for j in range(nver)
            ])
            prot = (pa >= protect_from) | (pb >= protect_from)
            exact = jnp.where(prot, cur, exact)
        for j in range(nver):
            u2 = jax.lax.dynamic_update_slice(
                u2, exact[j].reshape(1, 1), (pa[j], pb[j])
            )
        # exact rowmax refresh for the (<= nver) touched rows
        for j in range(nver):
            row = jax.lax.dynamic_slice(u2, (pa[j], 0), (1, V))[0]
            rm = rm.at[pa[j]].set(jnp.max(row))
        c2 = jnp.max(rm)
        a2 = jnp.max(jnp.where(rm == c2, row_iota, -1))
        row2 = jax.lax.dynamic_slice(u2, (a2, 0), (1, V))[0]
        b2 = jnp.max(jnp.where(row2 == c2, col_iota, -1))
        verified = jnp.any((pa == a2) & (pb == b2)) | (c2 == 0)
        return u2, rm, a2, b2, c2, verified, pa, pb

    def cond(state):
        return ~state[5]

    state = round_((
        u2, rowmax, jnp.int32(-1), jnp.int32(-1), jnp.int32(0),
        jnp.bool_(False), jnp.full((nver,), -1, jnp.int32),
        jnp.full((nver,), -1, jnp.int32),
    ))
    u2, rm, a, b, c, _, pa, pb = jax.lax.while_loop(cond, round_, state)
    if return_verified:
        # the final iteration's verified bins: their ub entries hold EXACT
        # live counts (protected bins can only match queries below
        # protect_from, which never alias them)
        return a, b, c, u2.reshape(V * V), rm, pa, pb
    return a, b, c, u2.reshape(V * V), rm


def update_ub_after_merge(ub: jax.Array, rowmax: jax.Array, ta, tb, new_id,
                          nhits, vocab_size: int):
    """Per-round upper-bound maintenance after merging (ta, tb) -> new_id.

    Bounds for the new token's pairs derive from ub itself — no corpus
    pass: every new (X, v) pair sits where an old (b, v) pair was (X ends
    with b), and every (v, X) where an old (v, a) was, so row b / column a
    of ub bound them; nhits (= #X tokens) caps both. Reads happen BEFORE
    zeroing the merged bin: for a == b the old (a, a) count legitimately
    bounds (X, a) (``aaa -> [X, a]``). (X, X) sits where an old (b, a)
    pair was, so that bin bounds it.

    The rowmax cache stays exact at O(V): column new_id rose from zero
    (fresh token) so a vector max covers every untouched row; the two rows
    that changed in other columns (ta lost its (ta, tb) bin, new_id was
    written wholesale) are refreshed from the final table.

    Returns (ub', rowmax').
    """
    V = vocab_size
    u2 = ub.reshape(V, V)
    row_bound = jnp.minimum(jax.lax.dynamic_slice(u2, (tb, 0), (1, V)), nhits)
    col_bound = jnp.minimum(jax.lax.dynamic_slice(u2, (0, ta), (V, 1)), nhits)
    xx_bound = jnp.minimum(u2[tb, ta], nhits)
    u2 = u2.at[ta, tb].set(0)  # all (a, b) pairs were consumed
    u2 = jax.lax.dynamic_update_slice(u2, row_bound, (new_id, 0))
    u2 = jax.lax.dynamic_update_slice(u2, col_bound, (0, new_id))
    u2 = u2.at[new_id, new_id].set(xx_bound)
    rm = jnp.maximum(rowmax, col_bound[:, 0])
    row_ta = jax.lax.dynamic_slice(u2, (ta, 0), (1, V))[0]
    rm = rm.at[ta].set(jnp.max(row_ta))
    row_new = jax.lax.dynamic_slice(u2, (new_id, 0), (1, V))[0]
    rm = rm.at[new_id].set(jnp.max(row_new))
    return u2.reshape(V * V), rm


def _next_tokens(tokens: jax.Array) -> jax.Array:
    """tokens shifted left by one along the last axis, PAD-filled."""
    return jnp.roll(tokens, -1, axis=-1).at[..., -1].set(PAD)


def greedy_hits(tokens: jax.Array, first, second) -> jax.Array:
    """Boolean mask of pair positions merged by one leftmost-greedy pass
    (basic_tokenizer.zig:207-232), along the last axis.

    hit[i] True means (tokens[i], tokens[i+1]) merges; position i receives
    the new token and position i+1 dies. Overlapping candidates (only
    possible when first==second) resolve leftmost-first via a cummax parity
    scan over candidate runs.
    """
    a = tokens
    b = _next_tokens(tokens)
    c = (b >= 0) & (a == first) & (b == second)
    axis = tokens.ndim - 1
    idx = jax.lax.broadcasted_iota(jnp.int32, tokens.shape, axis)
    # last index (<= i) holding a non-candidate; -1 if none
    last_zero = jax.lax.cummax(jnp.where(c, -1, idx), axis=axis)
    parity_hit = c & (((idx - last_zero) % 2) == 1)
    return jnp.where(first == second, parity_hit, c)


def merge_pass(tokens: jax.Array, first, second, new_token):
    """One full greedy merge pass + compaction (device analogue of
    basic_tokenizer.zig:207-232): merge_pass_multi with a single slot.
    Returns (new_tokens, num_hits)."""
    table = jnp.stack([jnp.asarray(v, jnp.int32) for v in (first, second, new_token)])
    out, nhits = merge_pass_multi(tokens, table[None])
    return out, nhits[0]


@jax.named_scope("merge_pass")
def merge_pass_multi(tokens: jax.Array, table: jax.Array):
    """Apply up to K merges simultaneously in one pass + compaction.

    Group contract (callers guarantee it): slots pairwise distinct,
    chain-free both directions (no slot's b is another slot's a), no slot
    references a token minted by another slot, and a != b except possibly
    in slot 0. Disabled slots hold negative ids ((-2, -2, -2) or PAD rows)
    and never fire. Under that contract simultaneous application is
    bit-exact with sequential replay in slot order:

    1. no member can DESTROY another's candidate — that needs one of its
       two tokens hit or killed by another member, and every such case
       forces equal pairs, b_i == a_j or a_i == b_j, all excluded;
    2. no member can CREATE another's candidate — every adjacency a merge
       creates has that member's minted token in it, and minted tokens are
       never referenced in-group;
    3. within one member, a != b makes candidates non-overlapping, so
       leftmost-greedy fires all of them (slot 0's a == b case runs the
       parity scan of greedy_hits).

    Compaction is a two-operand **stable sort** on a 0/1 dead key: kept
    tokens keep their order and move to the front, dead slots sink to the
    PAD tail. Works along the last axis. Returns (new_tokens, nhits[K])
    with tokens prefix-compacted and nhits summed over rows. Runs under
    the named scope ``merge_pass``, which is how a profiler trace
    attributes device time to it.
    """
    K = table.shape[0]
    b = _next_tokens(tokens)
    hits = [greedy_hits(tokens, table[0, 0], table[0, 1])]
    for m in range(1, K):
        hits.append((b >= 0) & (tokens == table[m, 0]) & (b == table[m, 1]))
    hit_any = hits[0]
    for m in range(1, K):
        hit_any = hit_any | hits[m]
    written = tokens
    for m in range(K):
        written = jnp.where(hits[m], table[m, 2], written)
    killed = jnp.roll(hit_any, 1, axis=-1).at[..., 0].set(False)
    keep = (~killed) & (tokens >= 0)
    key = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    _, out = jax.lax.sort(
        (key, jnp.where(keep, written, PAD)), num_keys=1, is_stable=True
    )
    nhits = jnp.stack([jnp.sum(h.astype(jnp.int32)) for h in hits])
    return out, nhits


def train_chunk(tokens: jax.Array, length, merges: jax.Array, occupancy: jax.Array,
                num_merges, vocab_size: int, max_rounds: int):
    """Run up to ``max_rounds`` merge rounds (or until the target vocab or
    early-stop). The jitted hot loop of training (basic_tokenizer.zig:172-205
    semantics), as a ``lax.while_loop`` of fused rounds: sorted selection,
    then merge_pass.

    State / returns:
      tokens:    int32[N]  corpus stream, globally prefix-compacted
      length:    int32     number of valid tokens
      merges:    int32[M,3]  (first, second, new_token) rows, PAD-filled
      occupancy: int32[M]  per-merge occurrence count (for verbose/stats)
      num_merges: int32    merges completed so far
    """
    V = vocab_size
    M = merges.shape[0]
    target = jnp.minimum(num_merges + max_rounds, M)

    def cond(state):
        toks, L, mg, occ, k = state
        return (k < target) & (L >= 2)

    def body(state):
        toks, L, mg, occ, k = state
        ta, tb, cnt = select_top_pair_sorted(toks, V)
        new_id = VOCAB_START + k
        toks, nhits = merge_pass(toks, ta, tb, new_id)
        mg = mg.at[k].set(jnp.stack([ta, tb, new_id]))
        occ = occ.at[k].set(cnt)
        return toks, L - nhits, mg, occ, k + 1

    return jax.lax.while_loop(
        cond, body, (tokens, length, merges, occupancy, num_merges)
    )


def train_chunk_lazy(tokens: jax.Array, length, ub: jax.Array, merges: jax.Array,
                     occupancy: jax.Array, num_merges, vocab_size: int,
                     max_rounds: int, select_batch: int = 8,
                     merge_group: int = 1):
    """train_chunk with lazy upper-bound selection instead of the per-round
    sort. State adds ``ub``: int32[V*V] upper bounds on live pair counts
    (initialised from one full histogram; see select_top_pair_lazy for the
    soundness argument). Per round:

      1. pop+verify the argmax pair from ub              (O(pops) reductions)
      2. fused greedy merge + compaction                 (one streaming pass)
      3. ub[merged bin] = 0; bound the new token's row and column from ub
         itself (row b / column a copies capped by the selection count) —
         no extra corpus pass; the pops verify these bounds lazily when
         they rise to the top.

    With ``merge_group`` K > 1, each loop iteration tries to retire up to
    K argmax rounds with ONE merge pass AND one selection corpus pass.
    Soundness: after accepting pair P_i = (a_i, b_i) -> X_i, the count of
    a bin (a, b) is INVARIANT under P_i's merge iff a != b_i and b != a_i
    and (a, b) != (a_i, b_i) (no member of the bin's adjacencies is
    consumed; all created adjacencies involve X_i). So after writing P_i's
    ub bounds (update_ub_after_merge with the exact count as the hit cap —
    for a != b every candidate fires, so count == hits), the next member
    is just the new table argmax — accepted WITHOUT any further corpus
    pass iff its bin is in the selection's already-verified set (its ub
    value is then the exact pre-group == post-prefix count), it is
    chain-free w.r.t. every earlier member, and it references no minted
    token (minted rows/cols carry unverifiable bounds; if the argmax
    lands there the group simply ends). The accepted prefix applies
    simultaneously (merge_pass_multi's group contract) — bit-exact
    with sequential rounds, including the tie-break (the argmax-by-
    (count, first, second) over upper bounds with an exact winner is the
    true argmax: a tied bin with a larger pair id would itself have won
    the ub-argmax). A rejected member ends the group; it is re-selected
    next iteration against fresh counts.

    Identical output contract to train_chunk; faster per round because
    nothing is sorted and nothing is recounted eagerly.
    """
    V = vocab_size
    M = merges.shape[0]
    GK = merge_group
    target = jnp.minimum(num_merges + max_rounds, M)

    def cond(state):
        toks, L, u, rm, mg, occ, k = state
        return (k < target) & (L >= 2)

    row_iota = jax.lax.broadcasted_iota(jnp.int32, (V,), 0)
    # Two extension strategies, chosen statically by regime:
    # * shallow vocab (cheap, low-churn selects): each extension re-runs
    #   the full verified selection against the PRE-group stream — highest
    #   acceptance rate, one extra fused verify pass per member.
    # * deep vocab (flattened counts, verify churn dominates): extensions
    #   are FREE — just the table argmax, accepted only if already in the
    #   round's verified set. Groups break a bit more often, but a broken
    #   group costs nothing extra.
    # Both discriminators are static at trace time: shallow vocabs use
    # chained re-selects (low churn), and at deep vocabs the choice follows
    # the corpus size — big streams amortize the extra verify pass
    # (chained), small ones are dominated by flattened-count churn that
    # each re-select multiplies (membership). The thresholds were chosen
    # on other hardware and are untuned on the GPU; shrink re-traces per
    # capacity, so a long training switches as the stream compacts.
    chained_ext = GK > 1 and (V <= 1024 or tokens.shape[0] > 2**24)

    def body(state):
        toks, L, u, rm, mg, occ, k = state
        X0 = VOCAB_START + k
        vpa = vpb = None
        if chained_ext:
            # one packed pair stream shared by every selection this round
            sa, sb = pair_streams(toks)
            pid_stream = jnp.where(sb >= 0, sa * V + sb, -1)

            def count_fn(pa, pb):
                return jnp.stack([
                    jnp.sum((pid_stream == pa[j] * V + pb[j]).astype(jnp.int32))
                    for j in range(pa.shape[0])
                ])
        else:
            count_fn = None
        # hot = the previous round's last new token: its ub row/col were
        # just written as bounds, so verify their tops eagerly. At k == 0
        # this degenerates to byte row 255 — harmless exact writes.
        if GK > 1 and not chained_ext:
            # wider verify set (col_k=3): the next GK-1 argmaxes must land
            # in it for the group to extend — one fused corpus pass either
            # way, so extra bins are near-free relative to a broken group
            ta, tb, cnt, u, rm, vpa, vpb = select_top_pair_lazy(
                u, toks, V, batch=select_batch, rowmax=rm,
                hot=X0 - 1, return_verified=True, col_k=3,
            )
        elif chained_ext:
            ta, tb, cnt, u, rm, vpa, vpb = select_top_pair_lazy(
                u, toks, V, batch=select_batch, rowmax=rm,
                hot=X0 - 1, count_fn=count_fn, return_verified=True,
                col_k=3,
            )
        else:
            ta, tb, cnt, u, rm = select_top_pair_lazy(
                u, toks, V, batch=select_batch, rowmax=rm,
                hot=X0 - 1, count_fn=count_fn,
            )
        u, rm = update_ub_after_merge(u, rm, ta, tb, X0, cnt, V)
        ok0 = cnt > 0
        rows_ = [jnp.where(ok0, jnp.stack([ta, tb, jnp.int32(X0)]),
                           jnp.full((3,), -2, jnp.int32))]
        oks, cnts = [ok0], [cnt]
        firsts, seconds = [ta], [tb]
        for m in range(1, GK):
            Xm = X0 + m
            if chained_ext:
                # membership-first: the latest select's verified set
                # usually already holds the next argmax, making the
                # extension FREE; a miss falls back to one full
                # re-selection (the cond's untaken branch costs nothing).
                # The fallback's corpus pass still measures the PRE-group
                # stream (sound: bins referencing minted tokens keep
                # their bounds via protect_from).
                u2v = u.reshape(V, V)
                c_f = jnp.max(rm)
                ta_f = jnp.max(jnp.where(rm == c_f, row_iota, -1))
                row_f = jax.lax.dynamic_slice(
                    u2v, (jnp.maximum(ta_f, 0), 0), (1, V)
                )[0]
                tb_f = jnp.max(jnp.where(row_f == c_f, row_iota, -1))
                hit_mem = (
                    jnp.any((vpa == ta_f) & (vpb == tb_f)) & (tb_f >= 0)
                )
                nv0 = vpa.shape[0]

                def mem_branch(args):
                    u_, rm_, vpa_, vpb_ = args
                    return ta_f, tb_f, c_f, u_, rm_, vpa_, vpb_

                def sel_branch(args):
                    u_, rm_, _, _ = args
                    r = select_top_pair_lazy(
                        u_, toks, V, batch=select_batch,
                        rowmax=rm_, count_fn=count_fn, protect_from=X0,
                        return_verified=True,
                    )
                    ta_r, tb_r, c_r, u_r, rm_r, pa_r, pb_r = r
                    pad = nv0 - pa_r.shape[0]
                    pa_r = jnp.concatenate(
                        [pa_r, jnp.full((pad,), -1, jnp.int32)]
                    )
                    pb_r = jnp.concatenate(
                        [pb_r, jnp.full((pad,), -1, jnp.int32)]
                    )
                    return ta_r, tb_r, c_r, u_r, rm_r, pa_r, pb_r

                ta_m, tb_m, c_m, u, rm, vpa, vpb = jax.lax.cond(
                    hit_mem, mem_branch, sel_branch, (u, rm, vpa, vpb)
                )
                member_ok = (c_m > 0) & (tb_m >= 0)
            else:
                # the next argmax straight off the (bound-updated) table —
                # no corpus pass; O(V) via the rowmax cache
                u2v = u.reshape(V, V)
                c_m = jnp.max(rm)
                ta_m = jnp.max(jnp.where(rm == c_m, row_iota, -1))
                row_m = jax.lax.dynamic_slice(
                    u2v, (jnp.maximum(ta_m, 0), 0), (1, V)
                )[0]
                tb_m = jnp.max(jnp.where(row_m == c_m, row_iota, -1))
                member_ok = (
                    jnp.any((vpa == ta_m) & (vpb == tb_m))
                    & (c_m > 0) & (tb_m >= 0)
                )
            acc = (
                oks[m - 1] & member_ok & (k + m < target)
                & (ta_m != tb_m) & (ta_m < X0) & (tb_m < X0)
            )
            for j in range(m):
                acc = acc & (
                    ~((firsts[j] == ta_m) & (seconds[j] == tb_m))
                    & (seconds[j] != ta_m) & (firsts[j] != tb_m)
                )
            u, rm = jax.lax.cond(
                acc,
                lambda ur: update_ub_after_merge(
                    ur[0], ur[1], ta_m, tb_m, Xm, c_m, V
                ),
                lambda ur: ur,
                (u, rm),
            )
            rows_.append(jnp.where(
                acc, jnp.stack([ta_m, tb_m, jnp.int32(Xm)]),
                jnp.full((3,), -2, jnp.int32),
            ))
            oks.append(acc)
            cnts.append(c_m)
            # rejected members must not constrain later chain checks (they
            # are not in the group), but acc is monotone so it is moot;
            # mask anyway for clarity
            firsts.append(jnp.where(acc, ta_m, jnp.int32(-3)))
            seconds.append(jnp.where(acc, tb_m, jnp.int32(-3)))

        table = jnp.stack(rows_)  # (GK, 3)
        toks, nh = merge_pass_multi(toks, table)
        L = L - jnp.sum(nh)
        for m in range(GK):
            mg = mg.at[k + m].set(jnp.where(
                oks[m], table[m], jnp.full((3,), PAD, jnp.int32)
            ))
            occ = occ.at[k + m].set(jnp.where(oks[m], cnts[m], 0))
        g = oks[0].astype(jnp.int32)
        for m in range(1, GK):
            g = g + oks[m].astype(jnp.int32)
        return toks, L, u, rm, mg, occ, k + g

    rowmax0 = rowmax_of(ub, V)
    toks, L, u, _, mg, occ, k = jax.lax.while_loop(
        cond, body,
        (tokens, length, ub, rowmax0, merges, occupancy, num_merges),
    )
    return toks, L, u, mg, occ, k


def encode_replay(tokens: jax.Array, merges: jax.Array):
    """Encode by replaying the merge table in training order
    (basic_tokenizer.zig:71-88): one greedy pass + compaction per merge,
    as a ``lax.scan`` over the (M, 3) merge table. PAD rows are no-ops.

    Returns (tokens, length) with tokens prefix-compacted.
    """

    def step(toks, row):
        ta, tb, new_id = row[0], row[1], row[2]
        toks = jax.lax.cond(
            new_id >= 0, lambda t: merge_pass(t, ta, tb, new_id)[0],
            lambda t: t, toks,
        )
        return toks, None

    toks, _ = jax.lax.scan(step, tokens, merges)
    return toks, jnp.sum((toks >= 0).astype(jnp.int32))
