"""End-to-end BasicTokenizer tests — the reference test vectors through the
framework's flagship model (device + host backends)."""

import numpy as np
import pytest

from zigbpe_tpu import BasicTokenizer, InvalidTokenError
from zigbpe_tpu.models import oracle

SEEDED = [(ord("h"), ord("e"), 256), (256, ord("l"), 257), (ord("w"), ord("o"), 258)]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_encode_seeded(backend):
    # basic_tokenizer.zig:362-378
    tok = BasicTokenizer(SEEDED)
    assert tok.encode("hello world", backend=backend) == [
        257, ord("l"), ord("o"), ord(" "), 258, ord("r"), ord("l"), ord("d"),
    ]


def test_decode_seeded():
    # basic_tokenizer.zig:380-397
    tok = BasicTokenizer(SEEDED)
    assert tok.decode([257, ord("l"), ord("o"), ord(" "), 258, ord("r"), ord("l"), ord("d")]) == b"hello world"


@pytest.mark.parametrize("backend", ["host", "device"])
def test_train_hello(backend):
    # basic_tokenizer.zig:399-432
    tok = BasicTokenizer().train("hello world hello", 300, backend=backend)
    assert len(tok.merges) > 0
    assert tok.encode("hello", backend=backend) == [259]
    assert tok.decode([259]) == b"hello"


def test_train_device_matches_host():
    rng = np.random.default_rng(7)
    data = bytes(rng.integers(32, 127, 5000, dtype=np.uint8))
    dev = BasicTokenizer().train(data, 320, backend="device")
    host = BasicTokenizer().train(data, 320, backend="host")
    assert dev.merges == host.merges


def test_train_chunking_and_shrink():
    # chunked round loop + capacity shrink must not change results
    data = b"the quick brown fox jumps over the lazy dog " * 200
    a = BasicTokenizer().train(data, 300, backend="device", chunk_rounds=5)
    b = BasicTokenizer().train(data, 300, backend="host")
    assert a.merges == b.merges


def test_serde_round_trip(tmp_path):
    tok = BasicTokenizer(SEEDED)
    tok.save_merges(tmp_path / "m.txt")
    tok2 = BasicTokenizer.from_merges_file(tmp_path / "m.txt")
    assert tok2.merges == tok.merges


def test_decode_unknown():
    with pytest.raises(InvalidTokenError):
        BasicTokenizer(SEEDED).decode([300])


def test_decode_cyclic_table():
    # degenerate deserialized table must not hang/overflow
    with pytest.raises(InvalidTokenError):
        BasicTokenizer([(256, 97, 256)]).decode([256])


def test_deep_merge_chain_decode():
    # chain depth ~600 would overflow Python recursion; decode is iterative
    merges = [(97, 97, 256)] + [(255 + i, 97, 256 + i) for i in range(1, 600)]
    tok = BasicTokenizer(merges)
    assert tok.decode([256 + 599]) == b"a" * 601


def test_probe_round_trip_device():
    probe = "hello world!!!? (안녕하세요!) lol123 😉"
    tok = BasicTokenizer().train("hello world hello", 300, backend="device")
    ids = tok.encode(probe)
    assert tok.decode(ids).decode("utf-8") == probe
    assert ids == oracle.encode(probe, tok.merges)


def test_empty_and_tiny_inputs():
    tok = BasicTokenizer().train(b"", 300)
    assert tok.merges == []
    tok = BasicTokenizer().train(b"a", 300)
    assert tok.merges == []
    assert tok.encode(b"") == []
    assert tok.decode([]) == b""


@pytest.mark.slow
def test_golden_device(corpus_bytes, golden_merges):
    """Device training on the conformance corpus reproduces merges.txt."""
    tok = BasicTokenizer().train(corpus_bytes, 300, backend="device")
    assert tok.merges == golden_merges
    ids = tok.encode(corpus_bytes, backend="device")
    assert len(ids) == 128451
    assert tok.decode(ids) == corpus_bytes


def test_large_vocab_sorted_path_end_to_end():
    """vocab > LAZY_VOCAB_MAX routes the full train() driver through the
    sort-based selection fallback (no dense ub table); conformance holds
    end-to-end including early stop (basic_tokenizer.zig:188-191)."""
    import numpy as np

    rng = np.random.default_rng(33)
    data = bytes(rng.integers(97, 101, 3000, dtype=np.uint8))
    from zigbpe_tpu import train as train_mod

    assert 9000 > train_mod.LAZY_VOCAB_MAX
    got = train_mod.train(data, 9000)
    assert got == oracle.train(data, 9000)
    assert len(got) > 500  # the sorted path did real selection work


def test_large_vocab_sorted_path_with_checkpoint(tmp_path):
    data = b"the quick brown fox jumps over the lazy dog " * 30
    from zigbpe_tpu import train as train_mod

    d = tmp_path / "ck"
    got = train_mod.train(
        data, 9000, checkpoint_dir=str(d), checkpoint_every_chunks=1,
        chunk_rounds=16,
    )
    assert got == oracle.train(data, 9000)


def test_deep_vocab_lazy_membership_mode(tmp_path):
    # vocab in (1024, LAZY_VOCAB_MAX]: the lazy trainer's membership-mode
    # group extensions (free argmax accepted off the verified set) — the
    # config-2/deep-regime path, otherwise only run at deployment size. Running
    # 1000+ device rounds on the CPU mesh takes minutes, so the device
    # trainer resumes from a host-trained checkpoint just below the
    # vocab-1024 mode boundary and runs only the deep tail.
    from zigbpe_tpu import train as train_mod
    from zigbpe_tpu.models import numpy_backend
    from zigbpe_tpu.utils import checkpoint as ckpt

    rng = np.random.default_rng(7)
    data = bytes(rng.integers(32, 127, 16000, dtype=np.uint8))
    want = numpy_backend.train(data, 1100)
    assert len(want) == 844
    prefix = want[:810]  # resume at vocab 1066 > 1024: membership mode
    stream = np.asarray(numpy_backend.encode(data, prefix), np.int32)
    d = tmp_path / "ck"
    ckpt.save(d, prefix, stream, 1100, np.zeros(len(prefix), np.int32))
    got = train_mod.train(data, 1100, checkpoint_dir=str(d), chunk_rounds=16)
    assert got == want
