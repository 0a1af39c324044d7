"""Training driver: host-side loop around the jitted device hot loop.

The device does everything hot (histogram, selection, merge, compaction) in
chunks of rounds under one jit; the host only orchestrates chunk calls,
optional verbose printing (reference format, basic_tokenizer.zig:308-317),
and the *shrink schedule*: as the corpus compacts, the padded capacity is
halved between chunks so later rounds touch proportionally less HBM. Each
distinct capacity costs one compile; capacities are powers of two, so there
are O(log N) compiles total.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import core
from .utils.profiling import TimeStats

Merge = Tuple[int, int, int]

# Shrink floor: every capacity costs one compile of the chunk loop, and
# below this size a pass is too cheap for halving the stream to repay a
# compile, so the tail of a run stays at this capacity.
MIN_CAPACITY = 32768


def _round_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


@functools.partial(
    jax.jit,
    static_argnames=("vocab_size", "max_rounds"),
    donate_argnums=(0, 2, 3),
)
def _train_chunk(tokens, length, merges, occupancy, num_merges, *, vocab_size,
                 max_rounds):
    return core.train_chunk(
        tokens, length, merges, occupancy, num_merges,
        vocab_size=vocab_size, max_rounds=max_rounds,
    )


@functools.partial(
    jax.jit,
    static_argnames=("vocab_size", "max_rounds", "select_batch", "merge_group"),
    donate_argnums=(0, 2, 3, 4),
)
def _train_chunk_lazy(tokens, length, ub, merges, occupancy, num_merges, *,
                      vocab_size, max_rounds, select_batch=8, merge_group=1):
    return core.train_chunk_lazy(
        tokens, length, ub, merges, occupancy, num_merges,
        vocab_size=vocab_size, max_rounds=max_rounds,
        select_batch=select_batch, merge_group=merge_group,
    )


@functools.partial(jax.jit, static_argnames=("vocab_size",))
def _init_ub(tokens, *, vocab_size):
    return core.pair_histogram(tokens, vocab_size)


# --- instrumented per-round path (reference-taxonomy phase observability:
# the reference times sort / replace / generate-pairs / count-pairs per
# call, utils/time_statistics.zig:36-60; the fused chunk loop hides that
# split, so --time-stats-detailed trades per-round host syncs for it).
# The instrumented loop runs the SAME algorithms as the production chunk
# loop — lazy pop/verify selection (with the sorted path only where
# production itself would fall back) and the same merge/compaction — so
# the reported split describes production training. ---


@functools.partial(jax.jit, static_argnames=("vocab_size",),
                   donate_argnums=(1, 2))
def _select_round_jit(tokens, ub, rowmax, hot, *, vocab_size):
    return core.select_top_pair_lazy(
        ub, tokens, vocab_size, rowmax=rowmax, hot=hot,
    )


@functools.partial(jax.jit, static_argnames=("vocab_size",))
def _select_round_sorted_jit(tokens, *, vocab_size):
    return core.select_top_pair_sorted(tokens, vocab_size)


@functools.partial(jax.jit, donate_argnums=(0,))
def _merge_round_jit(tokens, ta, tb, new_id):
    return core.merge_pass(tokens, ta, tb, new_id)


@functools.partial(jax.jit, static_argnames=("vocab_size",),
                   donate_argnums=(0, 1))
def _ub_maint_jit(ub, rowmax, ta, tb, new_id, nhits, *, vocab_size):
    return core.update_ub_after_merge(
        ub, rowmax, ta, tb, new_id, nhits, vocab_size
    )


def _train_device_instrumented(
    tokens, length_host: int, vocab_size: int, start_merges, capacity: int,
    stats: TimeStats, verbose: bool, shrink: bool,
) -> List[Merge]:
    """Per-round loop with per-phase device timing in the reference's
    taxonomy (sort / replace; utils/time_statistics.zig:36-60), running
    the production algorithms: lazy pop/verify selection + bound
    maintenance under ``sort_pairs``, fused merge/compaction under
    ``replace_pairs``. Each phase ends with a host sync, so the split is
    real device time, at the price of ~2 host round trips per round."""
    M = vocab_size - core.VOCAB_START
    merges: List[Merge] = list(start_merges)
    lazy = vocab_size <= LAZY_VOCAB_MAX
    ub = rowmax = None
    if lazy:
        with stats.phase("count_pairs"):
            ub = _init_ub(tokens, vocab_size=vocab_size)
            rowmax = core.rowmax_of(ub, vocab_size)
            np.asarray(rowmax[0])
    while len(merges) < M and length_host >= 2:
        with stats.phase("sort_pairs"):
            if lazy:
                ta, tb, cnt, ub, rowmax = _select_round_jit(
                    tokens, ub, rowmax,
                    jnp.int32(core.VOCAB_START + len(merges) - 1),
                    vocab_size=vocab_size,
                )
            else:
                ta, tb, cnt = _select_round_sorted_jit(
                    tokens, vocab_size=vocab_size
                )
            pair = np.asarray(jnp.stack([ta, tb, cnt]))
        if int(pair[2]) == 0:
            break
        new_id = core.VOCAB_START + len(merges)
        with stats.phase("replace_pairs"):
            tokens, nhits = _merge_round_jit(
                tokens, jnp.int32(int(pair[0])), jnp.int32(int(pair[1])),
                jnp.int32(new_id),
            )
            nhits = int(nhits)
        if lazy:
            with stats.phase("sort_pairs"):
                ub, rowmax = _ub_maint_jit(
                    ub, rowmax, jnp.int32(int(pair[0])),
                    jnp.int32(int(pair[1])), jnp.int32(new_id),
                    jnp.int32(nhits), vocab_size=vocab_size,
                )
                np.asarray(rowmax[0])
        merges.append((int(pair[0]), int(pair[1]), new_id))
        length_host -= nhits
        if verbose:
            print(
                f"merge {len(merges)}/{M}: ({pair[0]},{pair[1]}) -> "
                f"{new_id} had {pair[2]} occurrences"
            )
        while shrink and capacity > MIN_CAPACITY and length_host <= capacity // 2:
            capacity //= 2
            tokens = tokens[:capacity]

    if len(merges) < M and length_host < 2:
        print("No more pairs to merge. Stopping early.")
    return merges


@functools.partial(jax.jit, static_argnames=("vocab_size",))
def _place_byte_hist(block, *, vocab_size):
    """Seed the V*V upper-bound table from a host-computed (256, 256)
    byte-pair histogram: a raw byte stream only populates the low block."""
    V = vocab_size
    ub = jnp.zeros((V, V), jnp.int32)
    return ub.at[:256, :256].set(block).reshape(V * V)


# Above this vocab size the dense V^2 upper-bound table gets expensive
# (memory + per-pop argmax); fall back to the sort-based selection.
LAZY_VOCAB_MAX = 8192


def upload(data: bytes, stats: Optional[TimeStats] = None):
    """Host->device staging only: pack + transfer the corpus and return
    (tokens, length, ub_seed_block). Splitting this from :func:`train`
    lets callers (bench, serving) account transfer and compute separately.
    ``ub_seed_block`` is the host-computed (256, 256) byte-pair histogram
    (or None), used to seed lazy selection without a device scatter."""
    with (stats or TimeStats.null()).phase("initial_tokens"):
        capacity = _round_capacity(len(data))
        tokens, length = core.pad_tokens(data, capacity)
    block = None
    with (stats or TimeStats.null()).phase("count_pairs"):
        from .native import fastio

        hist = fastio.byte_pair_hist(data)
        if hist is not None:
            block = jnp.asarray(hist)
    return tokens, length, block


def train(
    data: bytes,
    vocab_size: int,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    detailed_stats: bool = False,
    merge_group: Optional[int] = None,
) -> List[Merge]:
    """Train a BPE merge table on-device; exact reference semantics
    (basic_tokenizer.zig:140-205). Returns the ordered merge list.

    With ``checkpoint_dir`` set, a resumable checkpoint (merges.txt + the
    residual token stream) is written every ``checkpoint_every_chunks``
    chunks and training resumes from it if present (SURVEY.md §5).
    ``detailed_stats`` uses the instrumented per-round loop (see
    :func:`train_device`) for reference-taxonomy phase timing.
    """
    if vocab_size < core.VOCAB_START:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    if vocab_size > 0x10000:
        raise ValueError(f"vocab_size must fit u16, got {vocab_size}")

    M = vocab_size - core.VOCAB_START
    if M == 0 or len(data) < 2:
        return []

    start_merges: List[Merge] = []
    start_tokens = None
    if checkpoint_dir and resume:
        from .utils import checkpoint as ckpt

        if ckpt.exists(checkpoint_dir):
            start_merges, start_tokens, ck_vocab, start_occ = ckpt.load(checkpoint_dir)
            if ck_vocab != vocab_size:
                raise ValueError(
                    f"checkpoint vocab_size {ck_vocab} != requested {vocab_size}"
                )
            if len(start_merges) > M:
                raise ValueError("checkpoint has more merges than target vocab")

    with (stats or TimeStats.null()).phase("initial_tokens"):
        if start_tokens is not None:
            capacity = _round_capacity(start_tokens.size)
            tokens, length = core.pad_token_ids(start_tokens, capacity)
            merges = np.full((M, 3), core.PAD, np.int32)
            occupancy = np.zeros((M,), np.int32)
            merges[: len(start_merges)] = np.asarray(start_merges, np.int32).reshape(-1, 3)
            occupancy[: len(start_occ)] = start_occ
            merges = jnp.asarray(merges)
            occupancy = jnp.asarray(occupancy)
            k = jnp.int32(len(start_merges))
            k_host = len(start_merges)
            length_host = int(start_tokens.size)
        else:
            capacity = _round_capacity(len(data))
            tokens, length = core.pad_tokens(data, capacity)
            merges = jnp.full((M, 3), core.PAD, jnp.int32)
            occupancy = jnp.zeros((M,), jnp.int32)
            k = jnp.int32(0)
            k_host = 0
            length_host = len(data)

    ub_seed_block = None
    if start_tokens is None and vocab_size <= LAZY_VOCAB_MAX:
        with (stats or TimeStats.null()).phase("count_pairs"):
            # fresh byte corpus: the native C++ runtime counts pairs on
            # the host (only the 256x256 block is populated) — cheaper
            # than a device scatter over the uploaded stream
            from .native import fastio

            block = fastio.byte_pair_hist(data)
            if block is not None:
                ub_seed_block = jnp.asarray(block)

    return train_device(
        tokens, length, vocab_size,
        length_host=length_host,
        merges=merges, occupancy=occupancy, k=k, k_host=k_host,
        capacity=capacity, ub_seed_block=ub_seed_block,
        verbose=verbose, chunk_rounds=chunk_rounds, shrink=shrink,
        stats=stats, checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks,
        detailed_stats=detailed_stats, merge_group=merge_group,
    )


def train_device(
    tokens,
    length,
    vocab_size: int,
    *,
    length_host: int,
    merges=None,
    occupancy=None,
    k=None,
    k_host: int = 0,
    capacity: Optional[int] = None,
    ub_seed_block=None,
    verbose: bool = False,
    chunk_rounds: int = 64,
    shrink: bool = True,
    stats: Optional[TimeStats] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every_chunks: int = 4,
    detailed_stats: bool = False,
    select_batch: Optional[int] = None,
    merge_group: Optional[int] = None,
) -> List[Merge]:
    """Run the training chunk loop on an already device-resident corpus
    (see :func:`upload`). This is the compute path of :func:`train`,
    exposed so callers can account host->device staging separately.

    ``detailed_stats`` switches to an instrumented per-round loop that
    times selection and merge/compaction separately (the reference's
    per-phase taxonomy, utils/time_statistics.zig:36-60) at the price of
    one host sync per phase per round — use for profiling, not production.
    """
    M = vocab_size - core.VOCAB_START
    if merge_group is None:
        # consecutive argmax merges on text are mostly chain-free, so a group
        # of 4 retires several rounds per corpus pass (untuned on the GPU)
        merge_group = 4
    if merges is None:
        merges = jnp.full((M, 3), core.PAD, jnp.int32)
    if occupancy is None:
        occupancy = jnp.zeros((M,), jnp.int32)
    if k is None:
        k = jnp.int32(k_host)
    if capacity is None:
        capacity = tokens.shape[0]

    if detailed_stats:
        start = [tuple(int(v) for v in row) for row in np.asarray(merges[:k_host])]
        return _train_device_instrumented(
            tokens, length_host, vocab_size, start, capacity,
            stats or TimeStats(), verbose, shrink,
        )

    lazy = vocab_size <= LAZY_VOCAB_MAX
    ub = None
    if lazy:
        with (stats or TimeStats.null()).phase("count_pairs"):
            if ub_seed_block is not None:
                ub = _place_byte_hist(ub_seed_block, vocab_size=vocab_size)
            else:
                ub = _init_ub(tokens, vocab_size=vocab_size)

    chunks_done = 0
    while k_host < M and length_host >= 2:
        rounds = min(chunk_rounds, M - k_host)
        with (stats or TimeStats.null()).phase("merge_rounds"):
            if select_batch is None:
                # deep tables churn many near-top stale bounds per round
                # (counts flatten), so verify more entries per pass — and
                # small streams, where each verify pass is cheap relative
                # to the churn, go wider still; shallow tables converge in
                # ~1 pass and keep 8. The values are untuned on the GPU.
                # The choice is per-chunk: shrink walks a long run into the
                # wide-verify regime naturally.
                sb_chunk = (
                    8 if vocab_size <= 1024
                    else (32 if capacity <= 2**24 else 16)
                )
            else:
                sb_chunk = select_batch
            if lazy:
                tokens, length, ub, merges, occupancy, k = _train_chunk_lazy(
                    tokens, length, ub, merges, occupancy, k,
                    vocab_size=vocab_size, max_rounds=rounds,
                    select_batch=sb_chunk, merge_group=merge_group,
                )
            else:
                tokens, length, merges, occupancy, k = _train_chunk(
                    tokens, length, merges, occupancy, k,
                    vocab_size=vocab_size, max_rounds=rounds,
                )
            # one host round-trip for both scalars
            lk = np.asarray(jnp.stack([length, k]))
            length_host = int(lk[0])
            prev_k, k_host = k_host, int(lk[1])

        if verbose:
            mg = np.asarray(merges[prev_k:k_host])
            oc = np.asarray(occupancy[prev_k:k_host])
            for j in range(k_host - prev_k):
                # exact reference format (basic_tokenizer.zig:308-317)
                print(
                    f"merge {prev_k + j + 1}/{M}: ({mg[j, 0]},{mg[j, 1]}) -> "
                    f"{mg[j, 2]} had {oc[j]} occurrences"
                )

        # Shrink: the corpus only ever compacts; halve padded capacity when
        # the valid prefix fits, so later rounds stream less device memory.
        chunks_done += 1
        ckpt_due = bool(
            checkpoint_dir and (chunks_done % checkpoint_every_chunks == 0)
        )
        while shrink and capacity > MIN_CAPACITY and length_host <= capacity // 2:
            capacity //= 2
            tokens = tokens[:capacity]

        if ckpt_due:
            from .utils import checkpoint as ckpt

            ckpt.save(
                checkpoint_dir,
                [tuple(int(v) for v in row) for row in np.asarray(merges[:k_host])],
                np.asarray(tokens)[:length_host],
                vocab_size,
                np.asarray(occupancy[:k_host]),
            )

    if k_host < M and length_host < 2:
        # reference early-stop notice (basic_tokenizer.zig:188-191)
        print("No more pairs to merge. Stopping early.")

    out = np.asarray(merges[:k_host])
    return [tuple(int(v) for v in row) for row in out]
