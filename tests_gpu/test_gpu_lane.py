"""The device paths compiled for the GPU, against the reference.

Every result on these paths is an integer (token ids, pair counts, merge
triples), so the card is compared with the reference exactly. No float
matrix product exists on them, so TF32 rounding does not apply.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_golden_train_compiled(gpu, corpus_bytes, golden_merges):
    """Device training on the conformance corpus reproduces the committed
    golden merges (reference merges.txt, tie at merge #39 included)."""
    from zigbpe_tpu import train as train_mod

    assert train_mod.train(corpus_bytes, 300) == golden_merges


def test_device_encode_compiled(gpu, corpus_bytes, golden_merges):
    from zigbpe_tpu import BasicTokenizer

    tok = BasicTokenizer(golden_merges)
    ids = tok.encode(corpus_bytes, backend="device")
    assert len(ids) == 128451  # golden compression (SURVEY §2.3.9)
    assert tok.decode(ids) == corpus_bytes


def test_batched_encode_compiled(gpu, corpus_bytes, golden_merges):
    """The batched encode on rows of the conformance corpus, plus empty,
    one-byte and parity-run rows, matches the oracle's replay."""
    from zigbpe_tpu import BasicTokenizer
    from zigbpe_tpu.models import oracle

    L = 1024
    docs = [corpus_bytes[i * L : (i + 1) * L] for i in range(4)]
    docs += [b"", b"a", b"aaaaaaa"]
    got = BasicTokenizer(golden_merges).encode_batch(docs, row_length=L)
    for d, ids in zip(docs, got):
        assert ids == oracle.encode(d, golden_merges)


def test_dp_one_device_mesh_compiled(gpu, corpus_bytes, golden_merges):
    """The data-parallel trainer on a one-GPU mesh gives the golden merges."""
    from zigbpe_tpu.parallel import train_dp as dp

    mesh = dp.data_mesh(np.asarray([gpu]))
    assert dp.train_dp(corpus_bytes, 300, mesh=mesh) == golden_merges
