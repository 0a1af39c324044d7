"""Smoke run of zigbpe's main path on one NVIDIA GPU.

Drives the library through the entry points a user calls
(``BasicTokenizer``, ``zigbpe_tpu.train.train``, ``train_dp.train_dp``),
in one process, phase by phase; any failure exits non-zero:

1. device: the card's name and power limit, ``jax.devices()``; stop unless
   JAX's first device is a GPU;
2. golden conformance: train the conformance corpus to vocab 300 on the
   card — merges.txt byte-identical to the reference's — encode it on the
   device (128,451 tokens) and round-trip decode;
3. training at deployment size (BASELINE config 2): 100 MB to vocab 1,280,
   cold and warm, merges identical to the native C++ trainer, merges.txt
   save/load round trip;
4. batched encode: the 1,024-merge table over 256 MB in 32,768-byte rows
   through ``BasicTokenizer.encode_batch``, every row identical to the
   native encoder's;
5. the GPU test lane (tests_gpu/) in this same process.

``--devices 4`` runs only the data-parallel path on four GPUs instead:
``train_dp`` over a ('data',) mesh against one-GPU ``train.train``, for
the replicated table (100 MB, vocab 1,280) and the row-sharded table
(8 MB, vocab 8,448).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Run from the repository root: python chip_smoke.py [--devices 4]
"""

import argparse
import concurrent.futures
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

import bench
from zigbpe_tpu import BasicTokenizer
from zigbpe_tpu import train as train_mod
from zigbpe_tpu.native import fastio
from zigbpe_tpu.parallel import train_dp as dp
from zigbpe_tpu.utils import serde

REPO = pathlib.Path(__file__).resolve().parent
DATA_DIR = REPO / "tests" / "data"
PROBE = "hello world!!!? (안녕하세요!) lol123 😉"
GOLDEN_TOKENS = 128451
MB = 1 << 20


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def phase_golden(corpus: bytes, golden_path: pathlib.Path,
                 n_tokens: int = GOLDEN_TOKENS) -> None:
    """Train to vocab 300 on the device; merges.txt must be byte-identical
    to the golden file; device encode gives ``n_tokens`` tokens; decode
    round-trips the corpus and the probe string."""
    tok = BasicTokenizer().train(corpus, 300, backend="device")
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "merges.txt"
        tok.save_merges(path)
        check(path.read_bytes() == golden_path.read_bytes(),
              "merges.txt differs from the golden file")
    ids = tok.encode(corpus, backend="device")
    check(len(ids) == n_tokens, f"corpus encodes to {len(ids)} tokens, want {n_tokens}")
    check(tok.decode(ids) == corpus, "decode does not round-trip the corpus")
    probe_ids = tok.encode(PROBE, backend="device")
    check(tok.decode(probe_ids).decode() == PROBE, "probe string does not round-trip")
    log(f"golden: merges.txt identical ({len(tok.merges)} merges), "
        f"{len(corpus)} bytes -> {len(ids)} tokens, decode round-trips")


def phase_train(data: bytes, vocab: int, card: str,
                prefix_bytes: int = 16 * MB, native_budget_s: float = 180.0):
    """Train cold and warm through train.train; compare with the native
    trainer on the same bytes (on a ``prefix_bytes`` prefix when the native
    run would take over ``native_budget_s``); merges.txt round trip.
    Returns the merges."""
    merges, cold_s = timed(train_mod.train, data, vocab)
    check(len(merges) == vocab - 256, f"trained {len(merges)} merges, want {vocab - 256}")
    warm, warm_s = timed(train_mod.train, data, vocab)
    check(warm == merges, "warm run's merges differ from the cold run's")
    mbytes = len(data) / 1e6
    log(f"train {len(data)} bytes -> vocab {vocab}: cold {cold_s:.3f} s "
        f"({mbytes / cold_s:.3f} MB/s), warm {warm_s:.3f} s "
        f"({mbytes / warm_s:.3f} MB/s) [{card}]")

    prefix = data[:prefix_bytes]
    native_prefix, native_prefix_s = timed(fastio.train, prefix, vocab)
    projected_s = native_prefix_s * len(data) / max(len(prefix), 1)
    if len(prefix) == len(data):
        check(native_prefix == merges, "device merges differ from the native trainer's")
        log(f"native trainer identical ({native_prefix_s:.3f} s)")
    elif projected_s <= native_budget_s:
        native, native_s = timed(fastio.train, data, vocab)
        check(native == merges, "device merges differ from the native trainer's")
        log(f"native trainer identical on all {len(data)} bytes ({native_s:.3f} s)")
    else:
        device_prefix = train_mod.train(prefix, vocab)
        check(device_prefix == native_prefix,
              "device merges differ from the native trainer's on the prefix")
        log(f"native trainer identical, compared on a {len(prefix)}-byte prefix: "
            f"the full native run would take ~{projected_s:.0f} s")

    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "merges.txt"
        serde.save(merges, path)
        check(serde.load(path) == merges, "merges.txt save/load does not round-trip")
    log("merges.txt save/load round-trips")
    return merges


def phase_encode(merges, data: bytes, row: int, card: str, workers: int = 0) -> None:
    """encode_batch over ``data`` as ``row``-byte rows, cold and warm;
    every row must equal the native encoder's output."""
    tok = BasicTokenizer(merges)
    docs = [data[i : i + row] for i in range(0, len(data) - row + 1, row)]
    got, cold_s = timed(tok.encode_batch, docs, row_length=row)
    got2, warm_s = timed(tok.encode_batch, docs, row_length=row)
    check(got2 == got, "warm encode differs from the cold encode")
    n_bytes = len(docs) * row
    n_tokens = sum(map(len, got))
    log(f"encode_batch {len(docs)} rows x {row} bytes ({n_bytes} bytes) -> "
        f"{n_tokens} tokens: cold {cold_s:.3f} s, warm {warm_s:.3f} s "
        f"({n_bytes / warm_s / 1e6:.3f} MB/s) [{card}]")

    # ctypes releases the interpreter lock, so native rows run in parallel
    with concurrent.futures.ThreadPoolExecutor(workers or os.cpu_count()) as ex:
        want, native_s = timed(lambda: list(ex.map(lambda d: fastio.encode(d, merges), docs)))
    check(sum(map(len, want)) == n_tokens,
          f"total tokens {n_tokens} != native {sum(map(len, want))}")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    check(not bad, f"{len(bad)} rows differ from the native encoder, first {bad[:5]}")
    log(f"native encoder identical on all {len(docs)} rows ({native_s:.3f} s)")


class _LaneCounter:
    """pytest plugin: counts passed, failed and skipped test calls."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.skipped:
            self.skipped += 1
        elif report.failed:
            self.failed += 1
        elif report.when == "call":
            self.passed += 1


def phase_test_lane() -> None:
    """Run tests_gpu/ in this process: every test must pass, none skip."""
    import pytest

    counter = _LaneCounter()
    rc = pytest.main(
        [str(REPO / "tests_gpu"), "-q", "-p", "no:cacheprovider", "-rs"],
        plugins=[counter],
    )
    check(rc == 0 and counter.failed == 0 and counter.skipped == 0
          and counter.passed > 0,
          f"GPU test lane: rc {rc}, {counter.passed} passed, "
          f"{counter.failed} failed, {counter.skipped} skipped")
    log(f"GPU test lane: {counter.passed} passed")


def phase_dp(data: bytes, vocab: int, devices, card: str) -> None:
    """train_dp over a ('data',) mesh of ``devices`` against one-device
    train.train on the same bytes."""
    one, one_s = timed(train_mod.train, data, vocab)
    mesh = dp.data_mesh(np.asarray(devices))
    many, many_s = timed(dp.train_dp, data, vocab, mesh=mesh)
    table = "row-sharded" if vocab > dp.LAZY_VOCAB_MAX else "replicated"
    check(many == one, f"train_dp on {len(devices)} devices ({table} table) "
          f"differs from one device")
    log(f"train_dp {len(devices)} devices, {table} table, {len(data)} bytes -> "
        f"vocab {vocab}: {len(many)} merges identical to one device; "
        f"one device {one_s:.3f} s, {len(devices)} devices {many_s:.3f} s "
        f"(both cold) [{card}]")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4: run only the data-parallel path on 4 GPUs")
    args = parser.parse_args(argv)

    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    cache_was_empty = not (
        cache_dir and os.path.isdir(cache_dir) and any(os.scandir(cache_dir))
    )
    devices = jax.devices()
    log(f"jax.devices(): {devices}")
    if devices[0].platform != "gpu":
        log(f"FAIL: chip_smoke needs an NVIDIA GPU; JAX found {devices[0].platform}")
        return 1
    card = bench.card_name_and_power_limit()
    log(f"card (name, power limit): {card}")
    card = "; ".join(card.splitlines())  # one tag for every timing line
    log(f"compile cache: {cache_dir} (empty at start: {cache_was_empty})")
    if len(devices) < args.devices:
        log(f"FAIL: --devices {args.devices} but JAX found {len(devices)} GPUs")
        return 1
    log(f"native library: {fastio.build()}")

    try:
        if args.devices == 1:
            corpus = (DATA_DIR / "taylorswift.txt").read_bytes()
            phase_golden(corpus, DATA_DIR / "merges.txt")
            merges = phase_train(bench.load_corpus(100 * MB), 1280, card)
            stats = devices[0].memory_stats() or {}
            log(f"peak_bytes_in_use after training: {stats.get('peak_bytes_in_use')}")
            phase_encode(merges, bench.load_corpus(256 * MB), 32768, card)
            phase_test_lane()
        else:
            used = devices[: args.devices]
            phase_dp(bench.load_corpus(100 * MB), 1280, used, card)
            phase_dp(bench.load_corpus(8 * MB), 8448, used, card)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    stats = devices[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": args.devices,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
