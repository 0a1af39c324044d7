"""zigbpe: a byte-level BPE tokenizer library in JAX.

Capability parity with dbtreasure/zig-bpe (train / encode / decode /
merges.txt serde / profiling), with the hot loops on the accelerator: pair
counting and lazy upper-bound selection with a deterministic tie-break,
vectorized leftmost-greedy merge passes, fixed-shape compaction, and
data-parallel training over a jax.sharding.Mesh with psum-reduced counts.
"""

import os as _os
import pathlib as _pathlib

# The persistent compilation cache's fixed home when nothing else names
# one: inside the checkout (listed in .gitignore), so every process of a
# checkout finds the executables the others compiled.
_CHECKOUT = _pathlib.Path(__file__).resolve().parent.parent
COMPILE_CACHE_DIR = _CHECKOUT / ".jax_cache"

# Compiles at least this long are cached: the shrink schedule's smaller
# capacities compile in 0.5-1 s, under JAX's default floor of 1 s.
CACHE_MIN_COMPILE_SECS = 0.5


def _configure_compile_cache() -> None:
    """Point JAX at a persistent compilation cache: the shrink schedule
    compiles one executable per power-of-two capacity, so a cold process
    pays a cascade of compiles that a cache absorbs.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and
    nothing is changed. Otherwise compiles from
    :data:`CACHE_MIN_COMPILE_SECS` up are cached, in the directory the
    application configured before import if it did, else in
    :data:`COMPILE_CACHE_DIR` when the package runs from a checkout
    (an installed package gets no default directory).
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    floor = jax.config.jax_persistent_cache_min_compile_time_secs
    if floor > CACHE_MIN_COMPILE_SECS:
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", CACHE_MIN_COMPILE_SECS
        )
    if not jax.config.jax_compilation_cache_dir and (
        _CHECKOUT / "pyproject.toml"
    ).is_file():
        jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))


_configure_compile_cache()

from .models.basic_tokenizer import BasicTokenizer, InvalidTokenError
from .models import oracle
from .utils import serde
from .utils.profiling import TimeStats

__version__ = "0.1.0"

__all__ = [
    "BasicTokenizer",
    "InvalidTokenError",
    "oracle",
    "serde",
    "TimeStats",
    "__version__",
]
