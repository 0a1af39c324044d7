"""Test configuration.

Tests run on a virtual 8-device CPU mesh, per SURVEY.md §4: single-device
vs multi-device merge-order equality is asserted on
`--xla_force_host_platform_device_count=8`. Tests that need a GPU live in
tests_gpu/.

Environment variables must be set before the first `import jax` anywhere in
the test process, hence this file does it at import time.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import pathlib

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running conformance tests")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Drop in-memory compiled executables between test modules. A long
    suite accumulates hundreds of distinct XLA CPU executables; past a
    threshold a later large compile segfaults inside XLA (observed twice,
    reproducibly at whichever heavy compile runs last). Clearing per module
    keeps the live-executable count bounded; the persistent disk cache
    absorbs most of the recompile cost."""
    yield
    jax.clear_caches()

# Conformance fixtures are VENDORED (tests/data/) so the golden suite is
# self-contained; the reference checkout, when present, is only used to
# cross-check that the vendored copies have not drifted (test_fixture_parity).
DATA_DIR = pathlib.Path(__file__).parent / "data"
CORPUS_PATH = DATA_DIR / "taylorswift.txt"
GOLDEN_MERGES_PATH = DATA_DIR / "merges.txt"
REFERENCE_DIR = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def corpus_bytes() -> bytes:
    """The reference conformance corpus (185,768 bytes of UTF-8 lyrics)."""
    return CORPUS_PATH.read_bytes()


@pytest.fixture(scope="session")
def golden_merges():
    """The reference's committed golden merge table: train(corpus, 300)."""
    from zigbpe_tpu.utils import serde

    return serde.load(GOLDEN_MERGES_PATH)


@pytest.fixture(scope="session")
def oracle_merges_300(corpus_bytes):
    """Oracle-trained merges on the conformance corpus, vocab 300 (44 merges)."""
    from zigbpe_tpu.models import oracle

    return oracle.train(corpus_bytes, 300)
