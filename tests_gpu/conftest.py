"""GPU test lane: tests that need an NVIDIA GPU.

Run it on a machine with a GPU:

    python -m pytest tests_gpu -q

chip_smoke.py runs this lane inside its own process (a second JAX process
could not get the card's memory). Whether a GPU is present is decided in
the ``gpu`` fixture when a test runs, never at import or collection, so
elsewhere every test here skips with a reason.
"""

import pathlib

import pytest

DATA_DIR = pathlib.Path(__file__).parent.parent / "tests" / "data"


@pytest.fixture
def gpu():
    """The first JAX device; skips the test unless it is a GPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {device.platform}")
    return device


@pytest.fixture(scope="session")
def corpus_bytes() -> bytes:
    return (DATA_DIR / "taylorswift.txt").read_bytes()


@pytest.fixture(scope="session")
def golden_merges():
    from zigbpe_tpu.utils import serde

    return serde.load(DATA_DIR / "merges.txt")
