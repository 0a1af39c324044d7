"""Layer probe on one NVIDIA GPU: the figures behind PERF.md's kernel
decisions (section 0) and time breakdown (section 5).

Sections, all by default or a comma-separated subset with ``--only``:

  merge   merge_pass_multi (4 slots) at 2^25..2^27 tokens: ms per pass,
          its compaction sort alone and a plain copy, the pass's share of
          3.35 TB/s at 8 bytes per token, and the sort's lowering in the
          compiled HLO.
  encode  encode_batch's scheduled groups against one merge pass per merge
          (core.encode_replay over the same rows) at 8,192 rows x 32,768
          bytes with the 1,024-merge table of 100 MB; the host time of
          schedule_merges and the grouped replay at 1,024 and 4,096 merges.
  trace   a jax.profiler trace of a warm 100 MB / vocab 1,280 training:
          the busiest device stream's busy time, window and idle share,
          the time under the ``merge_pass`` scope and the top kernels.
  dp      train_dp on a one-GPU mesh with the row-sharded table (8 MB,
          vocab 8,448) against train.train, cold and warm.

Prints one JSON object per section and writes them all to ``--out``.
Run from the repository root: python scripts/probe_h100.py [--only merge,dp]
"""

import argparse
import glob
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from zigbpe_tpu import train as train_mod
from zigbpe_tpu.ops import core
from zigbpe_tpu.ops import encode_batch as eb
from zigbpe_tpu.parallel import train_dp as dp

MB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak
DEVICE_PLANE = "/device:GPU"
# four chain-free merges ("e ", "th", "s ", "d "): the group contract holds
TABLE4 = np.array([[101, 32, 256], [116, 104, 257], [115, 32, 258],
                   [100, 32, 259]], np.int32)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def _best_ms_per_step(step, x, steps=10, reps=3):
    run = jax.jit(lambda t: jax.lax.fori_loop(0, steps, lambda i, u: step(u), t))
    run(x).block_until_ready()
    best = min(_timed(lambda: run(x).block_until_ready())[1] for _ in range(reps))
    return best / steps * 1e3, run


def probe_merge():
    table = jnp.asarray(TABLE4)
    out = {}
    for log2 in (27, 26, 25):
        n = 1 << log2
        x = jnp.asarray(np.frombuffer(bench.load_corpus(n), np.uint8).astype(np.int32))
        pass_ms, run = _best_ms_per_step(lambda t: core.merge_pass_multi(t, table)[0], x)
        sort_ms, _ = _best_ms_per_step(
            lambda t: jax.lax.sort(((t < 0).astype(jnp.int32), t), num_keys=1,
                                   is_stable=True)[1], x)
        copy_ms, _ = _best_ms_per_step(lambda t: t + 1, x)
        min_bytes = 8 * n
        out[n] = {
            "pass_ms": pass_ms, "sort_ms": sort_ms, "copy_ms": copy_ms,
            "share_of_hbm_peak": min_bytes / (pass_ms * 1e-3) / HBM_BYTES_PER_S,
            "share_of_copy": copy_ms / pass_ms,
        }
        if log2 == 27:
            hlo = run.lower(x).compile().as_text()
            out["sort_lowering"] = sorted({
                line.split('custom_call_target="')[1].split('"')[0]
                for line in hlo.splitlines() if 'custom_call_target="' in line
            })
            out["hlo_sort_ops"] = sum(" sort(" in line for line in hlo.splitlines())
        del x
    return out


def probe_encode():
    out = {}
    merges = train_mod.train(bench.load_corpus(100 * MB), 1280)
    deep = train_mod.train(bench.load_corpus(8 * MB), 4352)
    data = bench.load_corpus(256 * MB)
    row = 32768
    docs = [data[i : i + row] for i in range(0, len(data), row)]
    rows, _ = eb.pad_batch(docs, row)
    grouped = jax.jit(eb.encode_batch)
    for name, table in (("merges_1024", merges), ("merges_4096", deep)):
        t = np.asarray(table, np.int32)
        (gtable, glens), sched_s = _timed(eb.schedule_merges, t)
        gtable = jnp.asarray(gtable)
        runs = [_timed(lambda: grouped(rows, gtable)[1].block_until_ready())[1]
                for _ in range(3)]
        out[name] = {"schedule_host_s": sched_s, "groups": len(glens),
                     "grouped_s": runs}
    per_merge = jax.jit(core.encode_replay)
    table = jnp.asarray(np.asarray(merges, np.int32))
    runs = []
    for _ in range(2):
        (b, _), s = _timed(lambda: jax.block_until_ready(per_merge(rows, table)))
        runs.append(s)
    a = grouped(rows, jnp.asarray(eb.schedule_merges(np.asarray(merges, np.int32))[0]))[0]
    out["merges_1024"]["per_merge_s"] = runs
    out["merges_1024"]["identical"] = bool(jnp.array_equal(a, b))
    out["merges_1024"]["tokens_out"] = int(jnp.sum(a >= 0))
    return out


def _busy_ns(events):
    busy, end = 0, -1
    for s, e in sorted((ev.start_ns, ev.start_ns + ev.duration_ns) for ev in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def probe_trace():
    data = bench.load_corpus(100 * MB)
    train_mod.train(data, 1280)
    _, warm_s = _timed(train_mod.train, data, 1280)
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            _, traced_s = _timed(train_mod.train, data, 1280)
        pb = glob.glob(f"{d}/**/*.xplane.pb", recursive=True)[0]
        prof = jax.profiler.ProfileData.from_file(pb)
    best = None
    for plane in prof.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            busy = _busy_ns(events)
            if best is None or busy > best[1]:
                best = (f"{plane.name} | {line.name}", busy, events)
    name, busy, events = best
    window = max(e.start_ns + e.duration_ns for e in events) - min(e.start_ns for e in events)
    by_name, scope_ns = {}, 0
    for e in events:
        calls, ns = by_name.get(e.name, (0, 0))
        by_name[e.name] = (calls + 1, ns + e.duration_ns)
        if any("merge_pass" in str(v) for _, v in e.stats):
            scope_ns += e.duration_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "warm_s": warm_s, "traced_s": traced_s, "stream": name,
        "events": len(events), "busy_s": busy * 1e-9, "window_s": window * 1e-9,
        "idle_share": 1 - busy / window, "merge_pass_scope_s": scope_ns * 1e-9,
        "top": [[k[:90], c, ns * 1e-9] for k, (c, ns) in top],
    }


def probe_dp():
    data = bench.load_corpus(8 * MB)
    vocab = 8448
    mesh = dp.data_mesh(jax.devices()[:1])
    out = {}
    for run in ("cold", "warm"):
        one, one_s = _timed(train_mod.train, data, vocab)
        many, many_s = _timed(dp.train_dp, data, vocab, mesh=mesh)
        out[run] = {"train_s": one_s, "train_dp_1gpu_s": many_s,
                    "merges": len(many), "identical": many == one}
    return out


SECTIONS = {"merge": probe_merge, "encode": probe_encode,
            "trace": probe_trace, "dp": probe_dp}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(SECTIONS))
    parser.add_argument("--out", default="chiprun_out/probe_h100.json")
    args = parser.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"probe_h100 needs an NVIDIA GPU; JAX found {dev.platform}")
        return 1
    results = {"card": bench.card_name_and_power_limit(), "device": dev.device_kind}
    print(json.dumps(results), flush=True)
    for name in args.only.split(","):
        results[name] = SECTIONS[name]()
        print(json.dumps({name: results[name]}, default=str), flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(results, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
