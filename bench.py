"""Headline benchmark: BPE training throughput on one GPU, bytes/s.

Protocol (BASELINE.md: baselines are established by measurement — the
reference publishes none): corpus = the conformance corpus tiled to
BENCH_MB (default 32) MB; train 256 merges (vocab 256->512) on one GPU.

The headline is the DEVICE-PATH training throughput: corpus already
device-resident, measured over BENCH_RUNS runs (default 3), median
reported (best + all runs in the JSON line). Host->device staging is timed
separately and reported as ``upload_s`` / ``end_to_end_mbps``. Every timed
region ends with a host readback of its result.

``vs_baseline``: speedup over the repo's own native single-core C++
trainer (native/fastio.cpp zbpe_train — the honest reference-class
baseline; the Zig reference publishes no numbers, BASELINE.json:13),
measured on an 8 MB slice of the same corpus (every phase is linear in
corpus bytes).

The serving figure encodes the same corpus as 32,768-byte rows under a
frozen 1,024-merge table through ``BasicTokenizer.encode_batch``.

Exits non-zero without a GPU. Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline", ...extras}, naming the device it ran on.

Run: python bench.py
"""

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

BENCH_MB = int(os.environ.get("BENCH_MB", "32"))
MERGES = int(os.environ.get("BENCH_MERGES", "256"))
VOCAB = 256 + MERGES
RUNS = int(os.environ.get("BENCH_RUNS", "3"))
BASELINE_SLICE = 8 * 1024 * 1024
ROW = 32768


def load_corpus(total_bytes: int) -> bytes:
    """The vendored conformance corpus, tiled to ``total_bytes``."""
    seed = (pathlib.Path(__file__).parent / "tests" / "data" / "taylorswift.txt").read_bytes()
    reps = (total_bytes + len(seed) - 1) // len(seed)
    return (seed * reps)[:total_bytes]


def require_gpu():
    """JAX's devices, or SystemExit when the first one is not a GPU: a
    measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {devices[0].platform} devices "
            f"{devices}"
        )
    return devices


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of every card, as it
    prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    devices = require_gpu()
    card = card_name_and_power_limit()

    from zigbpe_tpu import BasicTokenizer
    from zigbpe_tpu import train as train_mod
    from zigbpe_tpu.native import fastio

    data = load_corpus(BENCH_MB << 20)
    mb = len(data) / 1e6

    # Warmup: a full-protocol run so every capacity in the shrink schedule
    # is compiled (and lands in the persistent cache) before timing.
    t0 = time.perf_counter()
    warm_merges = train_mod.train(data, VOCAB, chunk_rounds=64)
    warm_s = time.perf_counter() - t0
    assert len(warm_merges) == MERGES, f"expected {MERGES} merges, got {len(warm_merges)}"

    t0 = time.perf_counter()
    tokens, length, ub_block = train_mod.upload(data)
    tokens.block_until_ready()
    upload_s = time.perf_counter() - t0

    # Device-path training: median of RUNS timed runs. The chunk functions
    # donate their buffers, so each run trains on a device-side copy.
    runs_mbps = []
    for _ in range(RUNS):
        toks = jnp.copy(tokens).block_until_ready()
        t0 = time.perf_counter()
        merges = train_mod.train_device(
            toks, length, VOCAB, length_host=len(data),
            ub_seed_block=ub_block, chunk_rounds=64,
        )
        dt = time.perf_counter() - t0  # train_device ends with a host readback
        assert len(merges) == MERGES, f"expected {MERGES} merges, got {len(merges)}"
        runs_mbps.append(len(data) / dt / 1e6)
    median_mbps = statistics.median(runs_mbps)

    # Serving path (BASELINE.json config 3): a frozen 1K-merge table,
    # trained natively on a 1 MB slice (the table's provenance does not
    # affect replay cost), over the corpus as ROW-byte rows.
    tok = BasicTokenizer(fastio.train(data[: 1 << 20], 256 + 1024))
    docs = [data[i : i + ROW] for i in range(0, len(data) - ROW + 1, ROW)]
    tok.encode_batch(docs, row_length=ROW)  # compile + warm
    enc_runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        tok.encode_batch(docs, row_length=ROW)
        enc_runs.append(len(docs) * ROW / (time.perf_counter() - t0) / 1e6)

    # Native single-core C++ baseline: best of 3.
    base_slice = data[:BASELINE_SLICE]
    base_wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fastio.train(base_slice, VOCAB)
        base_wall = min(base_wall, time.perf_counter() - t0)
    native_mbps = len(base_slice) / base_wall / 1e6

    print(
        json.dumps(
            {
                "metric": f"bpe_train_device_throughput_{MERGES}merges_{BENCH_MB}MB",
                "value": median_mbps,
                "unit": "MB/s",
                "vs_baseline": median_mbps / native_mbps,
                "runs_mbps": runs_mbps,
                "upload_s": upload_s,
                "end_to_end_mbps": mb / (upload_s + mb / median_mbps),
                "warmup_s": warm_s,
                "native_baseline_mbps": native_mbps,
                "encode_batch_mbps_1kmerge": max(enc_runs),
                "encode_runs_mbps": enc_runs,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "card": card,
                "jax": jax.__version__,
                "numpy": np.__version__,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
