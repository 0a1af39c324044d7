"""Multi-host runtime helpers.

The reference is a single process (SURVEY.md §2.2). For multi-host training
the library uses JAX's single-controller-per-host SPMD model: every host
calls :func:`initialize`, loads only its contiguous corpus slice
(utils/fileio.host_slice), and runs the same data-parallel chunk
(parallel/train_dp) over a global mesh; selection verifies candidate pairs
with exact integer psums across every device of every host, and
the merge table + upper-bound table stay replicated — so merges are
bit-identical to single-host runs (SURVEY.md §7 stage 4).

This module cannot be exercised on single-host CI; it is covered by the
multi-chip dry run (virtual device mesh) plus these thin, testable shims.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed from explicit args or the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.
    No-op when running single-process."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info():
    """(process_id, process_count) of this host."""
    return jax.process_index(), jax.process_count()


def global_data_mesh():
    """A ('data',) mesh over every device in the job (all hosts)."""
    from .train_dp import data_mesh

    return data_mesh(jax.devices())


def train_from_files(
    paths,
    vocab_size: int,
    mesh=None,
    chunk_rounds: int = 64,
    verbose: bool = False,
    shrink: bool = True,
    checkpoint_dir=None,
    checkpoint_every_chunks: int = 4,
    resume: bool = True,
    stats=None,
):
    """Multi-host data-parallel training entry point: every process calls
    this with the same arguments after :func:`initialize`. Each host reads
    ONLY its own devices' contiguous byte ranges from the corpus files
    (train_dp.shard_corpus_from_files); selection psums span every host's
    devices; merges are bit-identical to single-host
    (tests/test_multihost.py runs this 2-process on localhost)."""
    from . import train_dp as dp

    mesh = mesh or global_data_mesh()
    start_merges, start_ids, start_occ = (
        dp._load_resume(checkpoint_dir, vocab_size, vocab_size - 256)
        if resume else ([], None, None)
    )
    if start_ids is not None:
        tokens = dp.shard_token_ids(start_ids, mesh)
        total = int(start_ids.size)
        ub_max_row = None  # resumed streams can populate any row
    else:
        tokens, total = dp.shard_corpus_from_files(paths, mesh)
        ub_max_row = 256  # fresh byte corpus
    return dp.train_dp_tokens(
        tokens, total, vocab_size, mesh,
        ub_max_row=ub_max_row,
        start_merges=start_merges,
        start_occ=start_occ if start_occ is not None else (),
        chunk_rounds=chunk_rounds, verbose=verbose, shrink=shrink,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_chunks=checkpoint_every_chunks, stats=stats,
    )
