"""Multi-host distributed build: 2-process virtual CPU cluster.

Proves that the sharded build over a multi-process mesh
(jax.distributed + gloo CPU collectives, all_to_all across the
process boundary = the cross-host path of a cluster) bitwise-matches the
single-host build, and the union-equivalence property (test.35
semantics: joint build == union of per-host DBs) holds across hosts.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_reads(tmp_path, seed: int):
    """Unequal file sizes so hosts run different chunk counts and the
    lockstep (BAD-block padding) path is actually exercised."""
    rng = np.random.default_rng(seed)
    files = []
    for i, n_reads in enumerate((24, 6, 2)):
        p = tmp_path / f"reads{i}.fasta"
        with open(p, "w") as fh:
            for r in range(n_reads):
                seq = "".join(rng.choice(list("ACGT"), size=150))
                fh.write(f">r{i}.{r}\n{seq}\n")
        files.append(str(p))
    return files


def _run_cluster(tmp_path, files, k=17, chunk=2048, nprocs=2):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # worker forces cpu itself
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(nprocs), str(port),
         str(tmp_path), str(k), str(chunk)] + files,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nprocs)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return [np.load(tmp_path / f"table_{pid}.npz")
            for pid in range(nprocs)]


@pytest.mark.slow
def test_distributed_build_bitwise_matches_single_host(tmp_path):
    files = _make_reads(tmp_path, seed=5)
    t0, t1 = _run_cluster(tmp_path, files)

    from kreeq_tpu.core.table import KmerTable

    want = KmerTable.from_reads(files, 17)
    for t in (t0, t1):  # both hosts hold the identical full table
        assert np.array_equal(t["keys"], want.keys)
        assert np.array_equal(t["cov"], want.cov)
        assert np.array_equal(t["fw"], want.fw)
        assert np.array_equal(t["bw"], want.bw)


@pytest.mark.slow
def test_distributed_cli_stdout_matches_single_process(tmp_path):
    """The real CLI under a 2-process launch: process 0's stdout must
    byte-match the single-process run (process 1 is silent)."""
    files = _make_reads(tmp_path, seed=3)
    asm = tmp_path / "asm.fasta"
    rng = np.random.default_rng(3)
    asm.write_text(">a\n" + "".join(rng.choice(list("ACGT"), size=400))
                   + "\n")
    argv = ["-m", "kreeq_tpu.cli.main", "validate", "-f", str(asm),
            "-r"] + files + ["-k", "17"]

    port = _free_port()
    base = dict(os.environ)
    base["JAX_PLATFORMS"] = "cpu"
    base["XLA_FLAGS"] = " ".join(
        [f for f in base.get("XLA_FLAGS", "").split()
         if "device_count" not in f]
        + ["--xla_force_host_platform_device_count=4"])
    base["KREEQ_TPU_NO_COMPILE_CACHE"] = "1"
    procs = []
    for pid in range(2):
        env = dict(base)
        env["KREEQ_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["KREEQ_TPU_NUM_PROCESSES"] = "2"
        env["KREEQ_TPU_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"CLI worker failed:\n{err.decode()}"
    single_env = dict(base)
    single = subprocess.run([sys.executable] + argv, env=single_env,
                            capture_output=True, timeout=600)
    assert single.returncode == 0, single.stderr.decode()
    def degloo(b):
        # the gloo CPU backend prints connection banners to stdout
        # ("[Gloo] ..." and "... peer ranks is : N", sometimes with a
        # leading newline); accelerator clusters don't use gloo, so filter
        # them — and any blank lines they leave behind at the head —
        # for comparison
        return b"".join(l for l in b.splitlines(keepends=True)
                        if not l.startswith(b"[Gloo]")
                        and b"peer ranks" not in l).lstrip(b"\n")

    got, want = degloo(outs[0][0]), single.stdout
    assert got == want, (  # byte-exact stats + QV
        f"distributed stdout diverged:\n--- got ---\n{got.decode()}"
        f"\n--- want ---\n{want.decode()}")
    assert degloo(outs[1][0]) == b""  # non-zero hosts stay silent


@pytest.mark.slow
def test_distributed_build_equals_per_host_union(tmp_path):
    """test.35 semantics across hosts: the joint distributed build
    equals `union` of DBs built independently from each host's shard."""
    files = _make_reads(tmp_path, seed=9)
    t0, _ = _run_cluster(tmp_path, files)

    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.parallel.multihost import shard_read_files

    host0 = KmerTable.from_reads(shard_read_files(files, 2, 0), 17)
    host1 = KmerTable.from_reads(shard_read_files(files, 2, 1), 17)
    union = host0.merge(host1)
    assert np.array_equal(t0["keys"], union.keys)
    assert np.array_equal(t0["cov"], union.cov)
    assert np.array_equal(t0["fw"], union.fw)
    assert np.array_equal(t0["bw"], union.bw)
