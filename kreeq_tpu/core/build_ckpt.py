"""Resumable DB build: chunk-batch checkpoints + a merge manifest.

The plain build (KmerTable.from_reads) holds all partial tree levels
in host/device memory, so a mid-build death (device fault, OOM kill,
operator error) loses everything.  The reference is no better —
its `.buf.m.bin` spills make the build memory-elastic but not
restartable (reference: src/graph-builder.cpp:134-216; its scaling
answer is per-read-set DBs + `kreeq union`, README.md:31-39).  This
module makes the device build itself restartable at chunk-batch
granularity:

  stage 1 — parts: the packed-chunk stream is consumed in batches of
    B chunks; each batch is counted + tree-merged on device
    (TreeMerger / ShardedCounter, same policy as from_reads) and the
    batch's sorted-unique table is written to `<ckpt>/<name>.*.npy`
    (atomic: tmp + rename), THEN recorded in `manifest.jsonl`.  A
    death mid-batch resumes by replaying the manifest, skipping the
    recorded number of chunks in the (deterministic) stream, and
    re-counting only the interrupted batch.

  stage 2 — merges: recorded parts are pairwise tree-merged smallest-
    first; every merge output is itself a recorded part and its inputs
    are deleted, so a death mid-merge re-pays at most one merge.
    Merges route device/host exactly like KmerTable.merge (host above
    the HBM threshold).

Saturating adds are associative only below the LARGEST clamp, so a
checkpointed build is bitwise-identical to the plain build unless a
counter crosses 2^32-1 across a different merge order — the same
order freedom the reference's largest-file-first mergeMaps already
has (reference: src/graph-builder.cpp:338-347).

Enabled via KREEQ_TPU_BUILD_CKPT=<dir> (from_reads delegates here).
KREEQ_TPU_BUILD_CKPT_BATCH overrides the chunks-per-part batch size.
The directory is left in place on success (holding only the manifest
and the final part) so a death between build and `.kreeq` write still
resumes cheaply; callers delete it once the DB is durable.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

MANIFEST = "manifest.jsonl"
_ARRS = ("keys", "cov", "fw", "bw")
_DTYPES = {"keys": np.uint64, "cov": np.uint32, "fw": np.uint32,
           "bw": np.uint32}


def _append_manifest(ckpt_dir: str, rec: dict) -> None:
    """Durable append: the record is the commit point for the files it
    names, so fsync both the line and (once per open) the directory."""
    path = os.path.join(ckpt_dir, MANIFEST)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    dfd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _read_manifest(ckpt_dir: str) -> list:
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                break  # torn tail line: everything before it stands
    return recs


def _write_part(ckpt_dir: str, name: str, arrs) -> None:
    for field, a in zip(_ARRS, arrs):
        tmp = os.path.join(ckpt_dir, f".{name}.{field}.tmp.npy")
        np.save(tmp, np.ascontiguousarray(a))
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(ckpt_dir, f"{name}.{field}.npy"))


def _read_part(ckpt_dir: str, name: str):
    return tuple(
        np.load(os.path.join(ckpt_dir, f"{name}.{field}.npy"))
        for field in _ARRS)


def _part_rows(ckpt_dir: str, name: str) -> int:
    # header-only read: np.load mmaps lazily with mmap_mode
    a = np.load(os.path.join(ckpt_dir, f"{name}.keys.npy"),
                mmap_mode="r")
    return int(a.shape[0])


def _delete_part(ckpt_dir: str, name: str) -> None:
    for field in _ARRS:
        try:
            os.remove(os.path.join(ckpt_dir, f"{name}.{field}.npy"))
        except OSError:
            pass


def _clean_tmp(ckpt_dir: str) -> None:
    for f in os.listdir(ckpt_dir):
        if f.startswith(".") and ".tmp.npy" in f:
            try:
                os.remove(os.path.join(ckpt_dir, f))
            except OSError:
                pass


class _CrashHook:
    """Test-only fault injection: KREEQ_TPU_BUILD_CKPT_CRASH_AFTER=<n>
    aborts the process-visible build after the n-th manifest append
    (parts and merges both count) — tests resume from the wreckage."""

    def __init__(self):
        v = os.environ.get("KREEQ_TPU_BUILD_CKPT_CRASH_AFTER")
        self.left = int(v) if v else None

    def tick(self):
        if self.left is None:
            return
        self.left -= 1
        if self.left <= 0:
            raise RuntimeError(
                "KREEQ_TPU_BUILD_CKPT_CRASH_AFTER fault injection")


def from_reads_checkpointed(read_files, k: int, ckpt_dir: str,
                            chunk: Optional[int] = None, mesh=None):
    """KmerTable.from_reads with on-disk resume state in `ckpt_dir`."""
    import jax.numpy as jnp

    from ..io.fastx import iter_reads
    from ..ops import kmers as K
    from ..utils import log
    from .table import KmerTable, ShardedCounter, TreeMerger

    if chunk is None:
        chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
    read_files = list(read_files)
    batch = int(os.environ.get("KREEQ_TPU_BUILD_CKPT_BATCH", "4"))
    os.makedirs(ckpt_dir, exist_ok=True)
    _clean_tmp(ckpt_dir)
    crash = _CrashHook()

    sizes = []
    for p in read_files:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(-1)
    header = {"op": "header", "k": k, "chunk": chunk, "batch": batch,
              "files": [os.path.abspath(p) for p in read_files],
              "sizes": sizes}

    recs = _read_manifest(ckpt_dir)
    if recs:
        h = recs[0]
        stale = {kk: vv for kk, vv in h.items() if kk != "op"} != \
            {kk: vv for kk, vv in header.items() if kk != "op"}
        if h.get("op") != "header" or stale:
            raise RuntimeError(
                f"checkpoint dir {ckpt_dir} belongs to a different "
                "build (k/chunk/batch/files mismatch); remove it or "
                "point KREEQ_TPU_BUILD_CKPT elsewhere")
        recs = recs[1:]
    else:
        _append_manifest(ckpt_dir, header)

    # replay: live part set + chunks already consumed + name counter
    live: dict[str, int] = {}  # name -> rows
    chunks_done = 0
    seq = 0
    stream_done = False
    for r in recs:
        if r["op"] == "part":
            live[r["name"]] = r["rows"]
            chunks_done += r["chunks"]
            seq += 1
        elif r["op"] == "merge":
            for name in r["ins"]:
                live.pop(name, None)
            live[r["out"]] = r["rows"]
            seq += 1
        elif r["op"] == "eof":
            stream_done = True
    # crashed merges may leave consumed-part files deleted later /
    # output files present but unrecorded — both safe: unrecorded
    # outputs are re-created (atomic rename), recorded merges always
    # have their output durable before inputs are deleted.
    if recs:
        log.verbose(
            f"build checkpoint: resuming with {len(live)} parts, "
            f"{chunks_done} chunks done, stream_done={stream_done}")
        # reclaim orphans: files of parts already consumed by a
        # recorded merge (death between record and delete) and
        # unrecorded merge outputs (death between write and record —
        # they will be re-created atomically)
        keep = {f"{name}.{field}.npy" for name in live
                for field in _ARRS}
        for f in os.listdir(ckpt_dir):
            if (f.endswith(".npy") and not f.startswith(".")
                    and f not in keep):
                try:
                    os.remove(os.path.join(ckpt_dir, f))
                except OSError:
                    pass

    def record_part(name: str, arrs, nchunks: int) -> None:
        rows = len(arrs[0])
        _write_part(ckpt_dir, name, arrs)
        _append_manifest(ckpt_dir, {"op": "part", "name": name,
                                    "rows": rows, "chunks": nchunks})
        live[name] = rows
        crash.tick()

    # ---- stage 1: consume the chunk stream into batch parts --------
    if not stream_done:
        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        chunks = K.pack_reads(read_iter(), k, chunk)
        for _ in range(chunks_done):  # deterministic stream: skip
            next(chunks, None)

        sharded = mesh is not None and mesh.devices.size > 1
        if sharded:
            sc = ShardedCounter(mesh, k, chunk)
        tm = None
        in_batch = 0

        def close_batch():
            nonlocal tm, in_batch, seq, chunks_done
            if in_batch == 0:
                return
            if sharded:
                arrs = sc.drain()
            else:
                arrs = tm.finalize_host()
                tm = None
            if arrs is not None:
                record_part(f"p{seq:05d}", arrs, in_batch)
                seq += 1
            chunks_done += in_batch
            in_batch = 0

        for buf in chunks:
            if sharded:
                sc.add(buf)
            else:
                if tm is None:
                    tm = TreeMerger()
                keys, _isfw, edges, valid = K.kmer_positions(
                    jnp.asarray(buf), k)
                ukeys, cov, fw, bw, n = K.count_sorted(keys, edges, valid)
                tm.push(tm.async_part((ukeys, cov, fw, bw), n))
            in_batch += 1
            if log.verbose_flag:
                log.verbose(
                    f"counted chunk {chunks_done + in_batch - 1} "
                    f"(batch {in_batch}/{batch})")
            if in_batch == batch:
                close_batch()
        close_batch()
        _append_manifest(ckpt_dir, {"op": "eof",
                                    "chunks": chunks_done})

    # ---- stage 2: tree-merge the recorded parts --------------------
    while len(live) > 1:
        a, b = sorted(live, key=lambda nm: (live[nm], nm))[:2]
        ta = KmerTable(k, *_read_part(ckpt_dir, a))
        tb = KmerTable(k, *_read_part(ckpt_dir, b))
        tm_out = ta.merge(tb)
        del ta, tb
        out = f"m{seq:05d}"
        seq += 1
        _write_part(ckpt_dir, out,
                    (tm_out.keys, tm_out.cov, tm_out.fw, tm_out.bw))
        _append_manifest(ckpt_dir, {"op": "merge", "out": out,
                                    "ins": [a, b],
                                    "rows": len(tm_out)})
        # inputs are dead only once the merge record is durable
        live.pop(a)
        live.pop(b)
        live[out] = len(tm_out)
        _delete_part(ckpt_dir, a)
        _delete_part(ckpt_dir, b)
        if log.verbose_flag:
            log.verbose(f"checkpoint merge {a}+{b} -> {out} "
                        f"({len(tm_out)} rows)")
        crash.tick()
        del tm_out

    if not live:
        return KmerTable.empty(k)
    (final,) = live
    return KmerTable(k, *_read_part(ckpt_dir, final))
