"""Scale features of the data-parallel trainer: the row-sharded ub table
(vocab > LAZY_VOCAB_MAX), the shrink schedule, and checkpoint/resume
interchange with the single-chip trainer."""

import numpy as np
import pytest

from zigbpe_tpu import train as train_mod
from zigbpe_tpu.models import oracle
from zigbpe_tpu.parallel import train_dp as dp
from zigbpe_tpu.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def mesh8():
    return dp.data_mesh()


def test_sharded_ub_matches_oracle(mesh8, monkeypatch):
    # force the sharded table at a small vocab so every sharded code path
    # (pops, verification writes, row/col maintenance) runs cheaply
    monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
    data = b"the quick brown fox jumps over the lazy dog " * 50
    got = dp.train_dp(data, 300, mesh=mesh8)
    assert got == oracle.train(data, 300)


def test_sharded_ub_device_count_invariance(monkeypatch):
    monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
    rng = np.random.default_rng(11)
    data = bytes(rng.integers(97, 103, 1500, dtype=np.uint8))
    import jax

    expect = oracle.train(data, 290)
    for ndev in (1, 4, 8):
        mesh = dp.data_mesh(np.asarray(jax.devices()[:ndev]))
        assert dp.train_dp(data, 290, mesh=mesh) == expect, f"ndev={ndev}"


def test_vocab_above_8192_wall(mesh8):
    # the round-1 hard cap at 8192 is gone: a vocab past it trains on the
    # sharded table and early-stops exactly like the oracle
    data = b"a" * 200 + b"b" * 100
    got = dp.train_dp(data, 9000, mesh=mesh8)
    assert got == oracle.train(data, 9000)


def test_shrink_invariance(mesh8):
    data = b"hello world hello " * 300
    with_shrink = dp.train_dp(data, 300, mesh=mesh8, shrink=True, chunk_rounds=8)
    without = dp.train_dp(data, 300, mesh=mesh8, shrink=False, chunk_rounds=8)
    assert with_shrink == without == oracle.train(data, 300)


def _mid_checkpoint(tmp_path, data: bytes, vocab: int, at: int):
    """Build a mid-training checkpoint (after ``at`` merges) from the
    oracle: state = (merges so far, residual token stream)."""
    full = oracle.train(data, vocab)
    assert at < len(full)
    ids = oracle.encode(data, full[:at])
    d = tmp_path / "ck"
    ckpt.save(d, full[:at], np.asarray(ids, np.int32), vocab,
              np.zeros(at, np.int32))
    return d, full


def test_dp_resume_from_single_chip_style_checkpoint(mesh8, tmp_path):
    data = b"the quick brown fox jumps over the lazy dog " * 40
    d, full = _mid_checkpoint(tmp_path, data, 300, at=20)
    got = dp.train_dp(data, 300, mesh=mesh8, checkpoint_dir=str(d))
    assert got == full


def test_single_chip_resume_from_dp_checkpoint(mesh8, tmp_path):
    data = b"the quick brown fox jumps over the lazy dog " * 40
    vocab = 300
    full = oracle.train(data, vocab)
    # dp writes a checkpoint every chunk, so the final state is on disk
    d = tmp_path / "dpck"
    got_dp = dp.train_dp(
        data, vocab, mesh=mesh8, chunk_rounds=8,
        checkpoint_dir=str(d), checkpoint_every_chunks=1,
    )
    assert got_dp == full
    assert ckpt.exists(d)
    merges, ids, ck_vocab, _ = ckpt.load(d)
    assert ck_vocab == vocab
    # the stream in the checkpoint is the corpus encoded by those merges
    assert ids.tolist() == oracle.encode(data, merges)
    # the single-chip trainer resumes it (here: already complete -> echoes)
    got_sc = train_mod.train(data, vocab, checkpoint_dir=str(d))
    assert got_sc == full


def test_single_chip_resume_midway_checkpoint(tmp_path):
    data = b"hello world hello " * 60
    d, full = _mid_checkpoint(tmp_path, data, 300, at=15)
    got = train_mod.train(data, 300, checkpoint_dir=str(d))
    assert got == full


def test_dp_checkpoint_stream_matches_replay(mesh8, tmp_path):
    rng = np.random.default_rng(12)
    data = bytes(rng.integers(97, 101, 1200, dtype=np.uint8))
    d = tmp_path / "ck2"
    dp.train_dp(data, 280, mesh=mesh8, chunk_rounds=4,
                checkpoint_dir=str(d), checkpoint_every_chunks=2)
    merges, ids, _, _ = ckpt.load(d)
    assert ids.tolist() == oracle.encode(data, merges)


def test_sharded_ub_init_subblocked_matches_unsharded(mesh8):
    # sub-blocked row histograms (the int32-overflow guard for Rl*V >= 2^31)
    # must produce the identical table as one-shot rows; exercised with a
    # tiny sub_rows so several sub-blocks run per row block
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    data = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    V, D = 264, mesh8.devices.size
    Vp = -(-V // D) * D
    tokens = dp.shard_corpus(data, mesh8)
    whole = dp._init_ub_sharded_jit(
        tokens, vocab_size=V, rows_per_shard=Vp // D, max_row=256, mesh=mesh8
    )
    subbed = dp._init_ub_sharded_jit(
        tokens, vocab_size=V, rows_per_shard=Vp // D, max_row=256, mesh=mesh8,
        sub_rows=5,
    )
    assert np.array_equal(np.asarray(whole), np.asarray(subbed))
    # ground truth: dense histogram of the byte stream
    ids = np.frombuffer(data, np.uint8).astype(np.int64)
    want = np.zeros((Vp, V), np.int32)
    np.add.at(want, (ids[:-1], ids[1:]), 1)
    assert np.array_equal(np.asarray(whole), want)


def test_sharded_ub_bounds_sound_and_new_token_exact(mesh8):
    """After a chunk of rounds on the row-sharded table, every entry bounds
    the live pair count from above, and the newest token's row and column
    hold exact counts (they are written from the merged stream)."""
    rng = np.random.default_rng(14)
    data = bytes(rng.integers(97, 103, 3000, dtype=np.uint8))
    V, D, rounds = 300, mesh8.devices.size, 12
    Vp = -(-V // D) * D
    tokens = dp.shard_corpus(data, mesh8)
    ub = dp._init_ub_sharded_jit(
        tokens, vocab_size=V, rows_per_shard=Vp // D, max_row=256, mesh=mesh8
    )
    M = V - 256
    toks, ub, merges, _, k, _, _ = dp._dp_chunk_jit(
        tokens, ub,
        dp._replicate(np.full((M, 3), -1, np.int32), mesh8),
        dp._replicate(np.zeros((M,), np.int32), mesh8),
        dp._replicate(np.asarray(0, np.int32), mesh8),
        vocab_size=V, max_rounds=rounds, mesh=mesh8, sharded_ub=True,
    )
    assert int(k) == rounds
    got = [tuple(int(v) for v in row) for row in np.asarray(merges)[:rounds]]
    assert got == oracle.train(data, 256 + rounds)
    stream = dp._gather_valid_stream(toks, D).astype(np.int64)
    exact = np.zeros((Vp, V), np.int64)
    np.add.at(exact, (stream[:-1], stream[1:]), 1)
    ub = np.asarray(ub)
    assert (ub >= exact).all()
    newest = 256 + rounds - 1
    assert np.array_equal(ub[newest], exact[newest])
    assert np.array_equal(ub[:, newest], exact[:, newest])
