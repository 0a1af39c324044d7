"""Data-parallel BPE training over a jax.sharding.Mesh.

The reference is single-threaded (SURVEY.md §2.2 — no parallelism exists to
port); this module adds it: the corpus is sharded contiguously across a
1-D ``('data',)`` mesh axis, selection state is reduced with collectives
each round (NCCL on GPUs), and the merge table stays replicated. Results are
**bit-identical** to single-chip training for any shard count:

* Every shard keeps its slice prefix-compacted; the global token sequence is
  the concatenation of shard prefixes.
* **Boundary pairs**: shard d owns the pair (its last valid token, the first
  valid token of the next non-empty shard), fetched via tiny all_gathers —
  so every global adjacent pair is counted exactly once (SURVEY.md §7 hard
  part 3). Ownership is by the LEFT token: a pair is counted, matched and
  merged by the shard holding its first token, and the right shard only
  learns (through an all_gather of boundary-hit flags) that its first token
  was consumed. Empty shards are skipped when looking for the right
  neighbour, so ownership is well defined for any shard lengths, and the
  global stream — the concatenation of shard prefixes — is the same stream
  the single-device trainer holds.
* **Selection is lazy** (same architecture as ops.core.train_chunk_lazy),
  with two layouts for the upper-bound table:
  - vocab <= LAZY_VOCAB_MAX: the table is REPLICATED; every shard pops the
    identical sequence and candidate bins are verified with one psum of
    shard-local exact counts — per-round collectives are O(batch + D)
    scalars.
  - vocab > LAZY_VOCAB_MAX: the dense table no longer fits replicated, so
    it is SHARDED BY ROWS over the mesh (the scaling-book recipe: shard the
    big state, exchange small messages). Pops become local-argmax +
    all_gather of (count, first, second) triples; verification is the same
    psum of scalars; table maintenance psums the new token's exact row
    and column counts (two V-vectors) per round.
* **Cross-shard greedy parity**: leftmost-greedy overlap resolution
  (basic_tokenizer.zig:207-232 semantics) runs on *global* pair indices: a
  cummax parity scan locally, with a carry-in equal to the max global index
  of a non-candidate pair in any earlier shard (SURVEY.md §7 hard part 1).
  A candidate run spanning shards therefore resolves exactly as on one chip.
* A boundary merge writes the new token into the left shard and kills the
  right shard's first token (flag exchanged via all_gather).
* Counting uses integer psum — deterministic, so the argmax + tie-break is
  bit-stable across any device count (SURVEY.md §7 hard part 2).
* **Compaction** is a per-shard stable sort on a 0/1 dead key — the same
  formulation the single-chip trainer uses.
* **Shrink schedule**: as shards compact, the per-shard padded capacity is
  halved between chunks (one recompile per power of two, like train.py).
* **Checkpoint/resume** shares utils.checkpoint with the single-chip
  trainer: the state is (merges, occupancy, global compacted stream), so a
  run checkpointed from either trainer resumes on the other.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import core
from ..ops.core import PAD, VOCAB_START

Merge = Tuple[int, int, int]

AXIS = "data"

# Above this vocab size the replicated dense V^2 ub table gets expensive
# (V=8192 is 256 MB per device); switch to the row-sharded table.
LAZY_VOCAB_MAX = 8192

# Per-shard capacity floor for the shrink schedule.
MIN_SHARD_CAPACITY = 256


def data_mesh(devices=None) -> Mesh:
    """A 1-D ('data',) mesh over the given (default: all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (AXIS,))


def _shard_pair_streams(tokens):
    """Per-shard (a, b, pair_valid, L, G) with the boundary pair included:
    shard d owns the pair (its last valid token, the first valid token of
    the next non-empty shard), exchanged via tiny all_gathers. The shard
    is a PAD-tailed prefix, so the boundary pair sits at slot L-1."""
    n = tokens.shape[0]
    D = jax.lax.axis_size(AXIS)
    d = jax.lax.axis_index(AXIS)
    idxs = jnp.arange(D, dtype=jnp.int32)

    valid_tok = tokens >= 0
    L = jnp.sum(valid_tok.astype(jnp.int32))
    lengths = jax.lax.all_gather(L, AXIS)          # [D] tiny
    firsts = jax.lax.all_gather(tokens[0], AXIS)   # [D] tiny
    nonempty = lengths > 0

    # First valid token of the next non-empty shard (the right halo).
    after = (idxs > d) & nonempty
    e_next = jnp.min(jnp.where(after, idxs, D))
    next_tok = jnp.where(e_next < D, firsts[jnp.minimum(e_next, D - 1)], PAD)

    # Global pair index offset: pairs of earlier shards come first.
    G = jnp.sum(jnp.where(idxs < d, lengths, 0))

    a, b = core.pair_streams(tokens)
    j = jnp.arange(n, dtype=jnp.int32)
    b = jnp.where(j == L - 1, next_tok, b)  # boundary pair at slot L-1
    pair_valid = (a >= 0) & (b >= 0)
    return a, b, pair_valid, L, G


def init_ub_dp(tokens, *, vocab_size: int):
    """Replicated upper-bound table: psum of per-shard histograms
    (boundary pairs counted exactly once). Runs inside shard_map."""
    V = vocab_size
    a, b, pair_valid, _, _ = _shard_pair_streams(tokens)
    pid = jnp.where(pair_valid, a * V + b, V * V)
    hist = jnp.zeros((V * V,), jnp.int32).at[pid].add(1, mode="drop")
    return jax.lax.psum(hist, AXIS)


def _dp_select_lazy(ub, rowmax, tokens, *, vocab_size: int, batch: int = 8,
                    hot=None):
    """Lazy batch-verified selection across shards: ub (and its rowmax pop
    cache) is replicated — every shard computes the identical pop sequence
    via ops.core.select_top_pair_lazy, with the exact-count pass overridden
    by a shard-local count + integer psum (deterministic, so the argmax +
    tie-break is bit-stable for any device count, SURVEY.md §7 hard part 2).
    The rowmax cache makes each pop O(V) instead of O(V^2) table reads —
    the same flat per-round cost the single-chip path has at deep vocabs."""
    V = vocab_size
    a, b, pair_valid, _, _ = _shard_pair_streams(tokens)
    pid_stream = jnp.where(pair_valid, a * V + b, -1)

    def count_fn(pa, pb):
        local = jnp.stack([
            jnp.sum((pid_stream == pa[j] * V + pb[j]).astype(jnp.int32))
            for j in range(pa.shape[0])
        ])
        return jax.lax.psum(local, AXIS)

    return core.select_top_pair_lazy(
        ub, None, V, batch=batch, rowmax=rowmax, count_fn=count_fn, hot=hot
    )


# --------------------------------------------------------------------------
# Row-sharded upper-bound table (vocab > LAZY_VOCAB_MAX)
# --------------------------------------------------------------------------


def _owned_entry_set(u, row_g, col, val, row0):
    """u[row_g - row0, col] = val when this shard owns global row row_g."""
    Rl = u.shape[0]
    own = (row_g >= row0) & (row_g < row0 + Rl)
    r = jnp.clip(row_g - row0, 0, Rl - 1)
    cur = jax.lax.dynamic_slice(u, (r, col), (1, 1))
    v = jnp.where(own, val, cur[0, 0]).reshape(1, 1).astype(u.dtype)
    return jax.lax.dynamic_update_slice(u, v, (r, col))


def _owned_row_max_refresh(rm, u, row_g, row0):
    """rm[row_g - row0] = max(u[row_g - row0, :]) on the shard that owns
    global row row_g; other shards keep their entry."""
    Rl = u.shape[0]
    own = (row_g >= row0) & (row_g < row0 + Rl)
    r = jnp.clip(row_g - row0, 0, Rl - 1)
    row = jax.lax.dynamic_slice(u, (r, 0), (1, u.shape[1]))[0]
    cur = jax.lax.dynamic_slice(rm, (r,), (1,))
    val = jnp.where(own, jnp.max(row), cur[0])
    return jax.lax.dynamic_update_slice(rm, val.reshape(1), (r,))


def _dp_select_lazy_sharded(u, rm, tokens, *, vocab_size: int, batch: int = 8):
    """Lazy batch-verified selection with the ub table SHARDED BY ROWS:
    u is the local (Vp/D, V) row block and rm its exact local per-row max
    (the pop cache — each pop reads O(V) local values, not the whole
    block).

    Pops are CHAIN-FREE, mirroring the single-chip selector: each shard
    takes its local top-``batch`` rows via one lax.top_k over the cache
    plus the top-2 columns of each in one batched top_k (no sequential
    masked argmaxes) and appends its local exact tie-break candidate; ONE
    all_gather shares every shard's candidate list and ONE psum of
    shard-local counts verifies them all, written back to their owning
    shards. That is 2 collectives per verify iteration instead of
    3 x batch sequential pmaxes, so the per-iteration cost does not grow
    with the collective latency. No hot row/column is popped: _dp_round
    writes the new token's row and column as exact counts, not bounds.

    The final argmax composes local caches with three scalar pmaxes
    lexicographically by (count, global row, col) — the exact tie-break —
    and, being reductions over the mesh axis, yields axis-invariant
    scalars, so the merge table and loop predicates stay replicated under
    shard_map's typing. Pair ids stay as (first, second) components —
    a flat a*V+b id would overflow int32 past V=46341 (the u16 vocab cap
    is 65536, basic_tokenizer.zig:140)."""
    V = vocab_size
    Rl = u.shape[0]
    D = jax.lax.axis_size(AXIS)
    d = jax.lax.axis_index(AXIS)
    row0 = d * Rl
    a, b, pair_valid, _, _ = _shard_pair_streams(tokens)

    r_iota = jax.lax.broadcasted_iota(jnp.int32, (Rl,), 0)
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (V,), 0)
    nver = D * (2 * batch + 1)

    def round_(state):
        u, rm = state[0], state[1]
        # local chain-free pops
        _, rows_loc = jax.lax.top_k(rm, batch)
        rows_mat = jnp.concatenate(
            [jax.lax.dynamic_slice(u, (rows_loc[j], 0), (1, V))
             for j in range(batch)], axis=0,
        )
        _, cols2 = jax.lax.top_k(rows_mat, 2)
        la_parts = [jnp.repeat(row0 + rows_loc, 2)]
        lb_parts = [cols2.reshape(-1)]
        # local exact tie-break candidate (top_k ties by smallest index;
        # the checked argmax ties by LARGEST (first, second))
        cl = jnp.max(rm)
        rl = jnp.max(jnp.where(rm == cl, r_iota, -1))
        rowl = jax.lax.dynamic_slice(u, (jnp.maximum(rl, 0), 0), (1, V))[0]
        bl = jnp.max(jnp.where(rowl == cl, c_iota, -1))
        la_parts.append((row0 + rl).reshape(1))
        lb_parts.append(jnp.maximum(bl, 0).reshape(1))
        la = jnp.concatenate(la_parts)
        lb = jnp.concatenate(lb_parts)
        # share candidates; verify all with one fused count pass + psum
        ga = jax.lax.all_gather(la, AXIS).reshape(-1)
        gb = jax.lax.all_gather(lb, AXIS).reshape(-1)
        local = jnp.stack(
            [jnp.sum((pair_valid & (a == ga[i]) & (b == gb[i])).astype(jnp.int32))
             for i in range(nver)]
        )
        exact = jax.lax.psum(local, AXIS)
        for i in range(nver):
            u = _owned_entry_set(u, ga[i], gb[i], exact[i], row0)
        for i in range(nver):
            rm = _owned_row_max_refresh(rm, u, ga[i], row0)
        # final argmax from the (exactly refreshed) caches
        cl = jnp.max(rm)
        rl = jnp.max(jnp.where(rm == cl, r_iota, -1))
        row = jax.lax.dynamic_slice(u, (rl, 0), (1, V))[0]
        bl = jnp.max(jnp.where(row == cl, c_iota, -1))
        mc = jax.lax.pmax(cl, AXIS)
        is_max = cl == mc
        ra = jax.lax.pmax(jnp.where(is_max, row0 + rl, -1), AXIS)
        cb = jax.lax.pmax(jnp.where(is_max & (row0 + rl == ra), bl, -1), AXIS)
        verified = jnp.any((ga == ra) & (gb == cb)) | (mc <= 0)
        return u, rm, ra, cb, mc, verified

    state = round_(
        (u, rm, jnp.int32(-1), jnp.int32(-1), jnp.int32(0), jnp.bool_(False))
    )
    u, rm, ra, cb, c2, _ = jax.lax.while_loop(lambda s: ~s[5], round_, state)
    return ra, cb, jnp.maximum(c2, 0), u, rm


def _xla_merge_shard(tokens, ta, tb, new_id):
    """The XLA merge formulation on a PREFIX-layout shard: greedy hits with
    cross-shard parity carry, boundary write/kill, stable-sort compaction.
    Returns (tokens', local_hits, local_keep)."""
    n = tokens.shape[0]
    D = jax.lax.axis_size(AXIS)
    d = jax.lax.axis_index(AXIS)
    idxs = jnp.arange(D, dtype=jnp.int32)
    j = jnp.arange(n, dtype=jnp.int32)

    a, b, pair_valid, L, G = _shard_pair_streams(tokens)
    valid_tok = tokens >= 0
    lengths = jax.lax.all_gather(L, AXIS)
    nonempty = lengths > 0

    # ---- greedy hits with global parity ----
    c = pair_valid & (a == ta) & (b == tb)
    gj = G + j
    real = j < L  # real pair slots of this shard (incl. boundary slot)
    lz_local = jax.lax.cummax(jnp.where(c, -1, gj))
    my_reset = jnp.max(jnp.where((~c) & real, gj, -1), initial=-1)
    resets = jax.lax.all_gather(my_reset, AXIS)    # [D] tiny
    carry_in = jnp.max(jnp.where(idxs < d, resets, -1), initial=-1)
    lz = jnp.maximum(lz_local, carry_in)
    hit = jnp.where(ta == tb, c & (((gj - lz) % 2) == 1), c)

    # ---- apply: write left, kill right (possibly across the boundary) ----
    boundary_hit = jnp.any(hit & (j == L - 1))
    bhits = jax.lax.all_gather(boundary_hit, AXIS)  # [D] tiny
    before = (idxs < d) & nonempty
    e_prev = jnp.max(jnp.where(before, idxs, -1), initial=-1)
    killed_first = (e_prev >= 0) & bhits[jnp.maximum(e_prev, 0)] & (L > 0)

    written = jnp.where(hit, new_id, tokens)
    killed = jnp.roll(hit, 1).at[0].set(False) | ((j == 0) & killed_first)
    keep = valid_tok & ~killed
    # stable-sort compaction on a 0/1 dead key (same formulation as
    # ops.core.merge_pass_multi)
    key = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    _, out = jax.lax.sort(
        (key, jnp.where(keep, written, PAD)), num_keys=1, is_stable=True
    )
    local_hits = jnp.sum(hit.astype(jnp.int32))
    local_keep = jnp.sum(keep.astype(jnp.int32))
    return out, local_hits, local_keep


def _dp_round(tokens, ub, rm, merges, occ, k, *, vocab_size: int,
              sharded_ub: bool):
    """One merge round on a shard of the corpus (runs inside shard_map).
    ``rm`` is the rowmax pop cache for ub (local rows for the sharded
    table, the full V rows replicated otherwise)."""
    V = vocab_size

    if sharded_ub:
        ta, tb, cnt, ub, rm = _dp_select_lazy_sharded(
            ub, rm, tokens, vocab_size=V,
        )
    else:
        ta, tb, cnt, ub, rm = _dp_select_lazy(
            ub, rm, tokens, vocab_size=V, hot=VOCAB_START + k - 1,
            batch=16 if V > 1024 else 8,
        )
    new_id = VOCAB_START + k
    tokens, local_hits, local_keep = _xla_merge_shard(tokens, ta, tb, new_id)

    merges = merges.at[k].set(jnp.stack([ta, tb, new_id]))
    occ = occ.at[k].set(cnt)

    if sharded_ub:
        # ---- ub maintenance: the merged bin empties; the new token's row
        # and column are EXACT counts on the merged stream (one masked
        # scatter each per shard, psum'd). Every other bin only loses
        # occurrences, so it stays a sound upper bound. Bounds copied from
        # row b / column a (the replicated path's derivation) sit at the
        # top of a flattened deep-vocab table and make the verify loop
        # churn; exact rows and columns leave it only real decrements. ----
        Rl = ub.shape[0]
        Vp = Rl * jax.lax.axis_size(AXIS)
        row0 = jax.lax.axis_index(AXIS) * Rl
        a, b, pair_valid, _, _ = _shard_pair_streams(tokens)
        row_x = jax.lax.psum(
            jnp.zeros((V,), jnp.int32)
            .at[jnp.where(pair_valid & (a == new_id), b, V)]
            .add(1, mode="drop"),
            AXIS,
        )  # (V,): counts of (new_id, v)
        col_x = jax.lax.psum(
            jnp.zeros((Vp,), jnp.int32)
            .at[jnp.where(pair_valid & (b == new_id), a, Vp)]
            .add(1, mode="drop"),
            AXIS,
        )  # (Vp,): counts of (v, new_id)
        # (ta, tb) empties: leftmost-greedy leaves no adjacent (ta, tb)
        ub = _owned_entry_set(ub, ta, tb, jnp.int32(0), row0)
        # write row new_id (owner only)
        own_new = (new_id >= row0) & (new_id < row0 + Rl)
        r_new = jnp.clip(new_id - row0, 0, Rl - 1)
        cur_row = jax.lax.dynamic_slice(ub, (r_new, 0), (1, V))
        ub = jax.lax.dynamic_update_slice(
            ub, jnp.where(own_new, row_x[None, :], cur_row), (r_new, 0)
        )
        # write column new_id (every shard writes its row block's slice;
        # its (new_id, new_id) entry equals row_x[new_id])
        my_col = jax.lax.dynamic_slice(col_x, (row0,), (Rl,))
        ub = jax.lax.dynamic_update_slice(ub, my_col[:, None], (0, new_id))
        # rowmax cache: column new_id rose from zero, so a vector max covers
        # untouched rows; the rows changed in other columns (ta zeroed its
        # (ta, tb) bin, new_id written wholesale) refresh at their owners
        rm = jnp.maximum(rm, my_col)
        rm = _owned_row_max_refresh(rm, ub, ta, row0)
        rm = _owned_row_max_refresh(rm, ub, new_id, row0)
    else:
        # bound maintenance as on one device (update_ub_after_merge: new
        # (X, v) pairs sit where old (b, v) pairs were, (v, X) where
        # (v, a), (X, X) where (b, a); all capped by the global hit count,
        # with the exact O(V) rowmax maintenance)
        nhits = jax.lax.psum(local_hits, AXIS)
        ub, rm = core.update_ub_after_merge(ub, rm, ta, tb, new_id, nhits, V)

    # psum (not a host-side sum of the gathered lengths) so the total carries
    # the replicated type through the while_loop
    total_len = jax.lax.psum(local_keep, AXIS)
    return tokens, ub, rm, merges, occ, k + 1, total_len


def _dp_chunk(tokens, ub, merges, occ, k, *, vocab_size: int, max_rounds: int,
              sharded_ub: bool):
    """Up to max_rounds rounds inside one shard_map body (while_loop).
    Returns the chunk state plus (total_len, max_shard_len) for the host's
    early-stop and shrink decisions."""
    M = merges.shape[0]
    target = jnp.minimum(k + max_rounds, M)
    total0 = jax.lax.psum(jnp.sum((tokens >= 0).astype(jnp.int32)), AXIS)
    # rowmax pop cache, recomputed once per chunk (one table read amortized
    # over max_rounds rounds) and maintained exactly inside the loop
    if sharded_ub:
        rm0 = jnp.max(ub, axis=1)
    else:
        rm0 = core.rowmax_of(ub, vocab_size)

    def cond(state):
        _, _, _, _, _, kk, total = state
        return (kk < target) & (total >= 2)

    def body(state):
        toks, u, rm, mg, oc, kk, _ = state
        toks, u, rm, mg, oc, kk, total = _dp_round(
            toks, u, rm, mg, oc, kk, vocab_size=vocab_size,
            sharded_ub=sharded_ub,
        )
        return toks, u, rm, mg, oc, kk, total

    toks, u, _, mg, oc, kk, total = jax.lax.while_loop(
        cond, body, (tokens, ub, rm0, merges, occ, k, total0)
    )
    maxlen = jax.lax.pmax(jnp.sum((toks >= 0).astype(jnp.int32)), AXIS)
    return toks, u, mg, oc, kk, total, maxlen


@functools.partial(
    jax.jit,
    static_argnames=("vocab_size", "max_rounds", "mesh", "sharded_ub"),
    donate_argnums=(0, 1, 2, 3),
)
def _dp_chunk_jit(tokens, ub, merges, occ, k, *, vocab_size, max_rounds, mesh,
                  sharded_ub):
    fn = jax.shard_map(
        functools.partial(
            _dp_chunk, vocab_size=vocab_size, max_rounds=max_rounds,
            sharded_ub=sharded_ub,
        ),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS, None) if sharded_ub else P(), P(), P(), P()),
        out_specs=(
            P(AXIS), P(AXIS, None) if sharded_ub else P(),
            P(), P(), P(), P(), P(),
        ),
    )
    return fn(tokens, ub, merges, occ, k)


@functools.partial(jax.jit, static_argnames=("vocab_size", "mesh"))
def _init_ub_jit(tokens, *, vocab_size, mesh):
    fn = jax.shard_map(
        functools.partial(init_ub_dp, vocab_size=vocab_size),
        mesh=mesh,
        in_specs=(P(AXIS),),
        out_specs=P(),
    )
    return fn(tokens)


def init_ub_sharded_dp(tokens, *, vocab_size: int, rows_per_shard: int,
                       max_row: int, sub_rows: Optional[int] = None):
    """Row-sharded ub init computed on device: for each row block q, every
    shard histograms its local pairs restricted to first-token rows
    [q*Rl, (q+1)*Rl) and the psum lands on shard q. Row blocks at or above
    ``max_row`` are skipped entirely — a fresh byte corpus only populates
    rows < 256, so its init is a single psum. Runs inside shard_map.

    Row blocks are histogrammed in sub-blocks of at most ``sub`` rows so
    the flat scatter id ``(a - r0) * V + b`` stays within int32 — with few
    shards and a large vocab, Rl * V can reach 2^31 (e.g. D=1 at
    V > 46340), where the id would overflow negative and scatter-drop,
    silently producing an unsound (too low) upper-bound table."""
    V = vocab_size
    Rl = rows_per_shard
    D = jax.lax.axis_size(AXIS)
    d = jax.lax.axis_index(AXIS)
    a, b, pair_valid, _, _ = _shard_pair_streams(tokens)
    out = jnp.zeros((Rl, V), jnp.int32)
    sub = sub_rows or min(Rl, max(1, (2**31 - 1) // V - 1))
    for q in range(D):
        r0 = q * Rl
        if r0 >= max_row:
            continue
        parts = []
        for s0 in range(0, Rl, sub):
            rs = min(sub, Rl - s0)
            if r0 + s0 >= max_row:
                parts.append(jnp.zeros((rs, V), jnp.int32))
                continue
            sel = pair_valid & (a >= r0 + s0) & (a < r0 + s0 + rs)
            pid = jnp.where(sel, (a - (r0 + s0)) * V + b, rs * V)
            hist = jnp.zeros((rs * V,), jnp.int32).at[pid].add(1, mode="drop")
            parts.append(jax.lax.psum(hist, AXIS).reshape(rs, V))
        block = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        out = jnp.where(d == q, block, out)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("vocab_size", "rows_per_shard", "max_row", "mesh", "sub_rows"),
)
def _init_ub_sharded_jit(tokens, *, vocab_size, rows_per_shard, max_row, mesh,
                         sub_rows=None):
    fn = jax.shard_map(
        functools.partial(
            init_ub_sharded_dp, vocab_size=vocab_size,
            rows_per_shard=rows_per_shard, max_row=max_row, sub_rows=sub_rows,
        ),
        mesh=mesh,
        in_specs=(P(AXIS),),
        out_specs=P(AXIS, None),
    )
    return fn(tokens)


@functools.partial(jax.jit, static_argnames=("new_cap", "mesh"), donate_argnums=(0,))
def _shrink_jit(tokens, *, new_cap, mesh):
    """Halve every shard's padded capacity (shards are prefix-compacted, so
    dropping the PAD tail is a static per-shard slice)."""
    fn = jax.shard_map(
        lambda t: t[:new_cap], mesh=mesh, in_specs=(P(AXIS),), out_specs=P(AXIS)
    )
    return fn(tokens)


def _shard_capacity(per: int, per_shard_capacity: Optional[int]) -> int:
    if per_shard_capacity is None:
        return max(MIN_SHARD_CAPACITY, 1 << (max(per, 1) - 1).bit_length())
    if per > per_shard_capacity:
        raise ValueError(f"shard slice {per} exceeds capacity {per_shard_capacity}")
    return per_shard_capacity


def _shard_int32(values: np.ndarray, mesh: Mesh,
                 per_shard_capacity: Optional[int] = None):
    """Place contiguous slices of an int32 stream into per-shard PAD-tailed
    prefixes; returns a [D * per_shard_capacity] array sharded over the mesh.

    Placement is callback-based (jax.make_array_from_callback), so under a
    multi-process runtime each host materializes only its own shards."""
    D = mesh.devices.size
    n = values.size
    per = (n + D - 1) // D
    cap = _shard_capacity(per, per_shard_capacity)

    def cb(index):
        d = (index[0].start or 0) // cap
        buf = np.full((cap,), PAD, dtype=np.int32)
        piece = values[d * per : (d + 1) * per]
        buf[: len(piece)] = piece
        return buf

    return jax.make_array_from_callback(
        (D * cap,), NamedSharding(mesh, P(AXIS)), cb
    )


def shard_corpus(data: bytes, mesh: Mesh, per_shard_capacity: Optional[int] = None):
    """Place contiguous corpus byte slices into per-shard PAD-tailed prefixes
    (byte-level init, basic_tokenizer.zig:155-170)."""
    return _shard_int32(
        np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32),
        mesh, per_shard_capacity,
    )


def shard_token_ids(ids: np.ndarray, mesh: Mesh,
                    per_shard_capacity: Optional[int] = None):
    """Re-shard a resumed token-id stream (checkpoint path). Shard
    boundaries may differ from the checkpointing run; training is
    boundary-invariant (test_dp_device_count_invariance)."""
    return _shard_int32(np.asarray(ids, dtype=np.int32), mesh, per_shard_capacity)


def shard_corpus_from_files(paths, mesh: Mesh,
                            per_shard_capacity: Optional[int] = None):
    """Shard a corpus spread over one or more files WITHOUT materializing it:
    each device's contiguous byte range is read straight from disk in the
    placement callback. Under a multi-process runtime each host therefore
    reads only its own devices' ranges (multi-host data loading,
    SURVEY.md §7 stage 4). Returns (tokens, total_bytes)."""
    import os

    from ..utils import fileio

    D = mesh.devices.size
    total = sum(os.path.getsize(p) for p in paths)
    per = (total + D - 1) // D
    cap = _shard_capacity(per, per_shard_capacity)

    def cb(index):
        d = (index[0].start or 0) // cap
        piece = fileio.read_range(paths, d * per, min((d + 1) * per, total))
        buf = np.full((cap,), PAD, dtype=np.int32)
        buf[: len(piece)] = np.frombuffer(piece, dtype=np.uint8)
        return buf

    tokens = jax.make_array_from_callback(
        (D * cap,), NamedSharding(mesh, P(AXIS)), cb
    )
    return tokens, total


# --------------------------------------------------------------------------
# Upper-bound table construction (host side)
# --------------------------------------------------------------------------


def _host_pair_entries(ids: np.ndarray):
    """Sparse exact pair counts of a host-resident token stream:
    (rows, cols, counts) int64/int64/int32 (overlaps included, reference
    semantics basic_tokenizer.zig:234-278)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size < 2:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int32))
    pid = ids[:-1] * 65536 + ids[1:]
    uniq, counts = np.unique(pid, return_counts=True)
    return uniq >> 16, uniq & 0xFFFF, counts.astype(np.int32)


def _byte_pair_entries(data: bytes):
    """Sparse byte-pair counts of a corpus (native C++ histogram when built,
    NumPy otherwise) — only bins < 256 are ever populated."""
    from ..native import fastio

    block = fastio.byte_pair_hist(data)
    if block is None:
        return _host_pair_entries(np.frombuffer(bytes(data), dtype=np.uint8))
    rows, cols = np.nonzero(block)
    return rows.astype(np.int64), cols.astype(np.int64), block[rows, cols].astype(np.int32)


def _replicate(arr: np.ndarray, mesh: Mesh):
    """Place a host array replicated over the mesh (multi-process safe:
    every host materializes the same value via the placement callback)."""
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, P()), lambda index: arr[index]
    )


def _replicated_ub_from_entries(rows, cols, counts, *, vocab_size, mesh):
    V = vocab_size
    tab = np.zeros((V, V), np.int32)
    tab[rows, cols] = counts
    return _replicate(tab.reshape(V * V), mesh)


def _sharded_ub_from_entries(rows, cols, counts, *, vocab_size, mesh):
    """Dense (Vp, V) table sharded by rows; Vp rounds V up to a multiple of
    the shard count (padded rows stay zero and are never addressed)."""
    V = vocab_size
    D = mesh.devices.size
    Vp = -(-V // D) * D
    sharding = NamedSharding(mesh, P(AXIS, None))

    def cb(index):
        r0 = index[0].start or 0
        r1 = index[0].stop if index[0].stop is not None else Vp
        local = np.zeros((r1 - r0, V), np.int32)
        m = (rows >= r0) & (rows < r1)
        local[rows[m] - r0, cols[m]] = counts[m]
        return local

    return jax.make_array_from_callback((Vp, V), sharding, cb)


def _gather_valid_stream(tokens, D: int) -> np.ndarray:
    """Global compacted token stream = concatenation of shard valid
    prefixes (checkpoint save path)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        arr = np.asarray(multihost_utils.process_allgather(tokens, tiled=True))
    else:
        arr = np.asarray(tokens)
    per = arr.size // D
    parts = [row[row >= 0] for row in arr.reshape(D, per)]
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


def _validate_vocab(vocab_size: int) -> int:
    if vocab_size < VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    if vocab_size > 0x10000:
        raise ValueError(f"vocab_size must fit u16, got {vocab_size}")
    return vocab_size - VOCAB_START


def _load_resume(checkpoint_dir, vocab_size: int, M: int):
    """(start_merges, start_ids, start_occ) from a checkpoint, if any."""
    from ..utils import checkpoint as ckpt

    if not (checkpoint_dir and ckpt.exists(checkpoint_dir)):
        return [], None, None
    start_merges, start_ids, ck_vocab, start_occ = ckpt.load(checkpoint_dir)
    if ck_vocab != vocab_size:
        raise ValueError(
            f"checkpoint vocab_size {ck_vocab} != requested {vocab_size}"
        )
    if len(start_merges) > M:
        raise ValueError("checkpoint has more merges than target vocab")
    return start_merges, start_ids, start_occ


def train_dp_tokens(
    tokens,
    total_tokens: int,
    vocab_size: int,
    mesh: Mesh,
    *,
    ub=None,
    ub_max_row: Optional[int] = None,
    start_merges: List[Merge] = (),
    start_occ=(),
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    stats=None,
) -> List[Merge]:
    """Run the data-parallel chunk loop on an already-sharded corpus.

    ``ub`` defaults to a device-computed init (psum histogram for the
    replicated table; per-row-block psum for the sharded table —
    ``ub_max_row`` bounds the populated first-token rows, 256 for a fresh
    byte corpus). This is the compute path shared by :func:`train_dp` and
    the multi-host entry point (parallel.multihost.train_from_files)."""
    from ..utils.profiling import TimeStats

    stats = stats or TimeStats.null()
    M = _validate_vocab(vocab_size)
    D = mesh.devices.size
    sharded_ub = vocab_size > LAZY_VOCAB_MAX
    per_shard_cap = tokens.shape[0] // D

    if ub is None:
        with stats.phase("count_pairs"):
            if sharded_ub:
                Vp = -(-vocab_size // D) * D
                ub = _init_ub_sharded_jit(
                    tokens, vocab_size=vocab_size, rows_per_shard=Vp // D,
                    max_row=min(ub_max_row or vocab_size, vocab_size), mesh=mesh,
                )
            else:
                ub = _init_ub_jit(tokens, vocab_size=vocab_size, mesh=mesh)

    mg0 = np.full((M, 3), PAD, np.int32)
    oc0 = np.zeros((M,), np.int32)
    if start_merges:
        mg0[: len(start_merges)] = np.asarray(start_merges, np.int32).reshape(-1, 3)
        oc0[: len(start_merges)] = np.asarray(
            start_occ[: len(start_merges)], np.int32
        )
    merges = _replicate(mg0, mesh)
    occ = _replicate(oc0, mesh)
    k = _replicate(np.asarray(len(start_merges), np.int32), mesh)

    k_host = len(start_merges)
    total_host = total_tokens
    chunks_done = 0
    while k_host < M and total_host >= 2:
        rounds = min(chunk_rounds, M - k_host)
        with stats.phase("merge_rounds"):
            tokens, ub, merges, occ, k, total, maxlen = _dp_chunk_jit(
                tokens, ub, merges, occ, k,
                vocab_size=vocab_size, max_rounds=rounds, mesh=mesh,
                sharded_ub=sharded_ub,
            )
            ktm = np.asarray(jnp.stack([k, total, maxlen]))  # one host round-trip
            prev_k, k_host, total_host = k_host, int(ktm[0]), int(ktm[1])
            maxlen_host = int(ktm[2])
        if verbose:
            mg = np.asarray(merges[prev_k:k_host])
            oc = np.asarray(occ[prev_k:k_host])
            for i in range(k_host - prev_k):
                print(
                    f"merge {prev_k + i + 1}/{M}: ({mg[i, 0]},{mg[i, 1]}) -> "
                    f"{mg[i, 2]} had {oc[i]} occurrences"
                )

        chunks_done += 1
        ckpt_due = bool(
            checkpoint_dir and (chunks_done % checkpoint_every_chunks == 0)
        )
        while (
            shrink
            and per_shard_cap > MIN_SHARD_CAPACITY
            and maxlen_host <= per_shard_cap // 2
        ):
            per_shard_cap //= 2
            tokens = _shrink_jit(tokens, new_cap=per_shard_cap, mesh=mesh)

        if ckpt_due:
            from ..utils import checkpoint as ckpt

            stream = _gather_valid_stream(tokens, D)
            if jax.process_index() == 0:
                ckpt.save(
                    checkpoint_dir,
                    [tuple(int(v) for v in row) for row in np.asarray(merges[:k_host])],
                    stream,
                    vocab_size,
                    np.asarray(occ[:k_host]),
                )

    if k_host < M and total_host < 2:
        print("No more pairs to merge. Stopping early.")

    out = np.asarray(merges[:k_host])
    return [tuple(int(v) for v in row) for row in out]


def train_dp(
    data: bytes,
    vocab_size: int,
    mesh: Optional[Mesh] = None,
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    stats=None,
) -> List[Merge]:
    """Data-parallel training; merge-order identical to single-chip/oracle.

    vocab_size <= LAZY_VOCAB_MAX uses the replicated ub table; larger
    vocabs (up to the u16 cap 65536, basic_tokenizer.zig:140) use the
    row-sharded table. With ``checkpoint_dir`` set, a resumable checkpoint
    is written every ``checkpoint_every_chunks`` chunks; checkpoints are
    interchangeable with the single-chip trainer (utils.checkpoint).
    """
    from ..utils.profiling import TimeStats

    stats = stats or TimeStats.null()
    M = _validate_vocab(vocab_size)
    if M == 0 or len(data) < 2:
        return []
    mesh = mesh or data_mesh()
    sharded_ub = vocab_size > LAZY_VOCAB_MAX

    start_merges, start_ids, start_occ = (
        _load_resume(checkpoint_dir, vocab_size, M) if resume else ([], None, None)
    )

    with stats.phase("initial_tokens"):
        if start_ids is not None:
            tokens = shard_token_ids(start_ids, mesh)
            total = int(start_ids.size)
        else:
            tokens = shard_corpus(data, mesh)
            total = len(data)

    # Host-computed ub init (exact; native C++ for the byte histogram) —
    # only valid single-process, where this host sees the whole stream.
    ub = None
    ub_max_row = None
    if jax.process_count() == 1:
        with stats.phase("count_pairs"):
            if start_ids is not None:
                rows, cols, counts = _host_pair_entries(start_ids)
            else:
                rows, cols, counts = _byte_pair_entries(data)
            if sharded_ub:
                ub = _sharded_ub_from_entries(
                    rows, cols, counts, vocab_size=vocab_size, mesh=mesh
                )
            else:
                ub = _replicated_ub_from_entries(
                    rows, cols, counts, vocab_size=vocab_size, mesh=mesh
                )
    elif start_ids is None:
        ub_max_row = 256  # fresh byte corpus: only byte rows are populated

    return train_dp_tokens(
        tokens, total, vocab_size, mesh,
        ub=ub, ub_max_row=ub_max_row,
        start_merges=start_merges,
        start_occ=start_occ if start_occ is not None else (),
        chunk_rounds=chunk_rounds, verbose=verbose, shrink=shrink,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks, stats=stats,
    )
