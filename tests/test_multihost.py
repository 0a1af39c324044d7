"""Real multi-process (2-host-on-localhost) data-parallel training:
jax.distributed over the CPU backend, each process owning 2 of 4 global
devices, asserting merge-order identity with the oracle (SURVEY.md §7
stage 4; the multi-host runtime the reference lacks, §2.2)."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from zigbpe_tpu.models import oracle

_CHILD = r"""
import sys

import jax

from zigbpe_tpu.parallel import multihost

corpus, out, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
multihost.initialize()  # from JAX_* env vars
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()
merges = multihost.train_from_files([corpus], 300, chunk_rounds=8)
if multihost.process_info()[0] == 0:
    with open(out, "w") as f:
        for a, b, t in merges:
            f.write(f"{a},{b},{t}\n")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_training_matches_oracle(tmp_path):
    data = b"the quick brown fox jumps over the lazy dog " * 60
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(data)
    out = tmp_path / "merges.txt"
    port = _free_port()

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(corpus), str(out), str(pid)],
                env=env,
                cwd=pathlib.Path(__file__).parent.parent,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{se.decode()[-3000:]}"

    got = [
        tuple(int(v) for v in line.split(","))
        for line in out.read_text().splitlines()
    ]
    assert got == oracle.train(data, 300)
