"""Resumable build checkpoints (core/build_ckpt.py).

The reference build is restartable only at whole-DB granularity (the
`.kreeq` DB is the checkpoint; a death mid-build restarts from zero —
reference: src/graph-builder.cpp:134-216, README.md:24-29).  This
build adds chunk-batch resume: parts + merge manifest on disk.  These
tests pin (a) bitwise equality with the plain build, (b) resume after
an injected crash at every stage without redoing completed batches,
(c) stale-checkpoint detection, (d) the same for the SPMD sharded
build on the 8-device CPU mesh (kill-and-resume bit-match).
"""

import json
import os

import numpy as np
import pytest


def _mk_reads(tmp_path, n=4000, seed=3, name="r.fasta"):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=n))
    reads = [genome[i:i + 120] for i in range(0, n - 150, 30)]
    rp = str(tmp_path / name)
    with open(rp, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r}\n")
    return rp


def _env(**kv):
    class _Ctx:
        def __enter__(self):
            self.old = {}
            for k, v in kv.items():
                self.old[k] = os.environ.get(k)
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = str(v)

        def __exit__(self, *exc):
            for k, v in self.old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return _Ctx()


def _assert_same(a, b):
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.cov, b.cov)
    assert np.array_equal(a.fw, b.fw)
    assert np.array_equal(a.bw, b.bw)


def test_checkpointed_build_matches_plain(tmp_path):
    from kreeq_tpu.core.table import KmerTable

    rp = _mk_reads(tmp_path)
    plain = KmerTable.from_reads([rp], 21, chunk=1024)
    ck = str(tmp_path / "ck")
    with _env(KREEQ_TPU_BUILD_CKPT=ck, KREEQ_TPU_BUILD_CKPT_BATCH=2):
        resumed = KmerTable.from_reads([rp], 21, chunk=1024)
    _assert_same(plain, resumed)
    # rerun from the completed checkpoint: loads the final part only
    with _env(KREEQ_TPU_BUILD_CKPT=ck, KREEQ_TPU_BUILD_CKPT_BATCH=2):
        again = KmerTable.from_reads([rp], 21, chunk=1024)
    _assert_same(plain, again)


@pytest.mark.parametrize("crash_after", [1, 2, 3, 5])
def test_crash_resume_bitwise(tmp_path, crash_after):
    from kreeq_tpu.core.table import KmerTable

    rp = _mk_reads(tmp_path)
    plain = KmerTable.from_reads([rp], 21, chunk=1024)
    ck = str(tmp_path / "ck")
    attempts = 0
    with _env(KREEQ_TPU_BUILD_CKPT=ck, KREEQ_TPU_BUILD_CKPT_BATCH=2):
        while True:
            attempts += 1
            assert attempts < 50
            with _env(KREEQ_TPU_BUILD_CKPT_CRASH_AFTER=crash_after):
                try:
                    out = KmerTable.from_reads([rp], 21, chunk=1024)
                    break
                except RuntimeError as e:
                    assert "fault injection" in str(e)
    assert attempts > 1  # the injection actually fired at least once
    _assert_same(plain, out)
    # completed batches were not re-counted: every chunk appears in
    # exactly one recorded part
    recs = [json.loads(line) for line in
            open(os.path.join(ck, "manifest.jsonl"))]
    nchunks = sum(r["chunks"] for r in recs if r["op"] == "part")
    eof = [r for r in recs if r["op"] == "eof"]
    assert len(eof) == 1 and nchunks == eof[0]["chunks"]


def test_stale_checkpoint_rejected(tmp_path):
    from kreeq_tpu.core.table import KmerTable

    rp = _mk_reads(tmp_path)
    ck = str(tmp_path / "ck")
    with _env(KREEQ_TPU_BUILD_CKPT=ck):
        KmerTable.from_reads([rp], 21, chunk=1024)
    with _env(KREEQ_TPU_BUILD_CKPT=ck):
        with pytest.raises(RuntimeError, match="different build"):
            KmerTable.from_reads([rp], 19, chunk=1024)


def test_sharded_crash_resume_bitwise(tmp_path):
    """Stretch (round-4 item 9): kill a sharded build mid-stream on
    the 8-device CPU mesh, resume, and bit-match the uninterrupted
    build (analog: the reference's restartable shard-DB + union
    workflow, src/graph-builder.cpp:297-351)."""
    import jax

    from kreeq_tpu.core.table import KmerTable
    from kreeq_tpu.parallel.sharded import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    rp = _mk_reads(tmp_path, n=6000)
    mesh = make_mesh()
    plain = KmerTable.from_reads([rp], 21, chunk=512, mesh=mesh)
    ck = str(tmp_path / "ck")
    attempts = 0
    with _env(KREEQ_TPU_BUILD_CKPT=ck,
              KREEQ_TPU_BUILD_CKPT_BATCH=2 * mesh.devices.size):
        while True:
            attempts += 1
            assert attempts < 50
            with _env(KREEQ_TPU_BUILD_CKPT_CRASH_AFTER=2):
                try:
                    out = KmerTable.from_reads([rp], 21, chunk=512,
                                               mesh=mesh)
                    break
                except RuntimeError as e:
                    assert "fault injection" in str(e)
    assert attempts > 1
    _assert_same(plain, out)
