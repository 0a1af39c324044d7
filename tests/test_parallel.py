"""Data-parallel conformance: N-device training == single-chip == oracle
(BASELINE.json config 4), on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from zigbpe_tpu.models import oracle
from zigbpe_tpu.parallel import train_dp as dp


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "tests require the 8-device CPU mesh"
    return dp.data_mesh()


def mesh_of(n):
    return dp.data_mesh(np.asarray(jax.devices()[:n]))


def test_shard_corpus_layout(mesh8):
    data = bytes(range(100))
    arr = np.asarray(dp.shard_corpus(data, mesh8, per_shard_capacity=32))
    shards = arr.reshape(8, 32)
    # 100 bytes over 8 shards -> 13 per shard (last has 9)
    assert shards[0, :13].tolist() == list(range(13))
    assert (shards[0, 13:] == -1).all()
    assert shards[7, :9].tolist() == list(range(91, 100))


def test_dp_matches_oracle_text(mesh8):
    data = b"the quick brown fox jumps over the lazy dog " * 100
    got = dp.train_dp(data, 300, mesh=mesh8)
    assert got == oracle.train(data, 300)


def test_dp_matches_oracle_random(mesh8):
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(97, 103, 4096, dtype=np.uint8))
    got = dp.train_dp(data, 310, mesh=mesh8)
    assert got == oracle.train(data, 310)


def test_dp_run_spanning_shards(mesh8):
    # long single-byte runs across shard boundaries exercise the global
    # parity carry (SURVEY §7 hard part 1)
    data = b"a" * 1000 + b"b" + b"a" * 1000 + b"bb" + b"a" * 500
    got = dp.train_dp(data, 280, mesh=mesh8)
    assert got == oracle.train(data, 280)


def test_dp_boundary_merges(mesh8):
    # corpus sized so pairs repeatedly straddle the 8 shard boundaries
    rng = np.random.default_rng(4)
    data = bytes(rng.integers(97, 99, 257, dtype=np.uint8))  # ragged shards
    got = dp.train_dp(data, 300, mesh=mesh8)
    assert got == oracle.train(data, 300)


def test_dp_tiny_corpus_empty_shards(mesh8):
    # fewer bytes than shards -> some shards start empty
    data = b"aaab"
    got = dp.train_dp(data, 300, mesh=mesh8)
    assert got == oracle.train(data, 300)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_dp_device_count_invariance(ndev):
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(32, 127, 2000, dtype=np.uint8))
    got = dp.train_dp(data, 290, mesh=mesh_of(ndev))
    assert got == oracle.train(data, 290)


def test_dp_chunking_invariance(mesh8):
    data = b"hello world hello " * 64
    a = dp.train_dp(data, 300, mesh=mesh8, chunk_rounds=3)
    b = dp.train_dp(data, 300, mesh=mesh8, chunk_rounds=64)
    assert a == b == oracle.train(data, 300)


def test_dp_early_stop(mesh8):
    got = dp.train_dp(b"ab" * 2, 400, mesh=mesh8)
    assert got == oracle.train(b"ab" * 2, 400)


def test_dp_large_shards_match_oracle(mesh8):
    # 32K-token shards (incl. cross-boundary merges and a==b rounds)
    # through train_dp_tokens
    rng = np.random.default_rng(11)
    data = bytes(rng.integers(97, 103, 40000, dtype=np.uint8))
    tokens = dp.shard_corpus(data, mesh8, per_shard_capacity=32768)
    got = dp.train_dp_tokens(tokens, len(data), 290, mesh8, chunk_rounds=16)
    assert got == oracle.train(data, 290)


def test_dp_parity_runs_across_shards(mesh8):
    # single-byte runs spanning shard boundaries: a==b rounds resolve
    # greedy parity on global pair indices
    data = b"a" * 9000 + b"bc" * 600 + b"a" * 7000
    tokens = dp.shard_corpus(data, mesh8, per_shard_capacity=32768)
    got = dp.train_dp_tokens(tokens, len(data), 272, mesh8, chunk_rounds=8)
    assert got == oracle.train(data, 272)
