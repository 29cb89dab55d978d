"""KmerTable: the device-resident sorted k-mer count table.

Replaces the reference's 128 u8 hash maps + u32 overflow maps
(reference: include/kreeq.h:138-148, maps/maps32) with a single sorted
structure-of-arrays {keys u64, cov u32, fw u32[4], bw u32[4]}.  The
two-level u8/u32 scheme is a CPU RAM optimization; on device a flat u32
SoA is strictly better and is observably equivalent (the reference
migrates a record to u32 before any counter can clip, so all observable
counts are exact u32 with LARGEST saturation — reference:
src/graph-builder.cpp:160-205).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

MAP_COUNT = 128  # on-disk partition count, pinned by .kreeq/.index files



def _pad_part(part, size):
    """Pad a trimmed (keys, cov, fw, bw) tuple with SENTINEL rows to a
    power-of-two size: merge shapes then repeat across calls, which
    matters because every new shape pair costs a full XLA compile."""
    import jax.numpy as jnp

    from ..ops.kmers import SENTINEL

    keys, cov, fw, bw = part
    n = keys.shape[0]
    if n == size:
        return part
    pad = size - n
    return (jnp.concatenate([keys, jnp.full((pad,), SENTINEL, keys.dtype)]),
            jnp.concatenate([cov, jnp.zeros((pad,), cov.dtype)]),
            jnp.concatenate([fw, jnp.zeros((pad, 4), fw.dtype)]),
            jnp.concatenate([bw, jnp.zeros((pad, 4), bw.dtype)]))


def _pow2(n: int) -> int:
    size = 1024
    while size < n:
        size *= 2
    return size


LARGEST = np.uint64(0xFFFFFFFF)


def host_merge_sorted(ak, ac, af, ab, bk, bc, bf, bb):
    """Union of two sorted-unique host tables with saturating adds —
    the out-of-core sibling of ops.kmers.merge_sorted, used when the
    merged operands would exceed device HBM (a device merge holds both
    inputs, the output, and sort workspace; see from_reads).  Two
    searchsorted passes compute every row's output position directly —
    no O(n log n) argsort of the concatenation."""
    na, nb = len(ak), len(bk)
    if na == 0:
        return bk.copy(), bc.copy(), bf.copy(), bb.copy()
    if nb == 0:
        return ak.copy(), ac.copy(), af.copy(), ab.copy()
    pos_a = np.searchsorted(bk, ak, side="left") + np.arange(na)
    pos_b = np.searchsorted(ak, bk, side="right") + np.arange(nb)
    n = na + nb
    keys = np.empty(n, np.uint64)
    cov = np.empty(n, np.uint32)
    fw = np.empty((n, 4), np.uint32)
    bw = np.empty((n, 4), np.uint32)
    keys[pos_a] = ak
    keys[pos_b] = bk
    cov[pos_a] = ac
    cov[pos_b] = bc
    fw[pos_a] = af
    fw[pos_b] = bf
    bw[pos_a] = ab
    bw[pos_b] = bb
    dup = np.zeros(n, bool)
    dup[1:] = keys[1:] == keys[:-1]  # a-row then b-row for shared keys
    if dup.any():
        i = np.nonzero(dup)[0]

        def satadd(arr):
            s = arr[i - 1].astype(np.uint64) + arr[i].astype(np.uint64)
            arr[i - 1] = np.minimum(s, LARGEST).astype(np.uint32)

        satadd(cov)
        satadd(fw)
        satadd(bw)
        keep = ~dup
        keys, cov, fw, bw = keys[keep], cov[keep], fw[keep], bw[keep]
    return keys, cov, fw, bw


def _host_merge_threshold() -> int:
    """Merged-row count above which tree merges run on the host.

    A device merge holds the two inputs, the output, and the
    payload-carrying sort workspace — ~6x the merged rows at ~44 B —
    and the build's tree levels below the threshold stay device-
    resident too (another ~2x threshold rows), so the threshold must
    be a small fraction of HBM: with the default max_device_rows
    (~45% of HBM / 44 B) a //4 cap keeps the whole build under ~60% of
    HBM.
    KREEQ_TPU_HOST_MERGE_ROWS overrides (tests force tiny values)."""
    env = os.environ.get("KREEQ_TPU_HOST_MERGE_ROWS")
    if env:
        return max(int(env), 1)
    return max(KmerTable.max_device_rows() // 4, 1 << 20)


class TreeMerger:
    """Pairwise tree-merge of per-chunk count parts.

    Extracted from from_reads (round 5) so the checkpointed builder
    (core/build_ckpt.py) can reuse the exact device/host merge policy
    per chunk-batch.  A part is (keys, cov, fw, bw, n) where n is the
    distinct-row count — a device scalar with an async host copy for
    freshly counted parts, a host int for stored ones.

    Pipelining: no step of the chunk loop blocks on the device.  Every
    part carries its distinct-count as a DEVICE scalar with an async
    host copy started at creation; a part is trimmed to pow2(n) only
    when it is next consumed by a merge, by which point its n has long
    materialized on the host.  Fresh parts enter merges untrimmed, so
    the only readbacks in the chunk loop are on counts from >= 1 chunk
    ago.  Merges whose output would strain HBM run on the host
    (the reference's spill-to-disk analog,
    src/graph-builder.cpp:213-216)."""

    def __init__(self):
        self.levels = []  # at most one part per tree level

    @staticmethod
    def async_part(arrs, n):
        try:
            n.copy_to_host_async()
        except AttributeError:
            pass
        return (*arrs, n)

    @staticmethod
    def _trim(part):
        """Slice a stored part down to pow2(n) SENTINEL-padded rows
        (the n readback is host-ready for stored parts)."""
        keys, cov, fw, bw, n = part
        size = _pow2(int(n))
        if size < keys.shape[0]:
            return (keys[:size], cov[:size], fw[:size], bw[:size], n)
        return part

    def merge(self, stored, fresh):
        from ..ops import kmers as K

        ns = int(stored[4])
        if ns + fresh[0].shape[0] > _host_merge_threshold():
            nf = int(fresh[4])
            a = tuple(np.asarray(x)[:ns] for x in stored[:4])
            b = tuple(np.asarray(x)[:nf] for x in fresh[:4])
            mk, mc, mf, mb = host_merge_sorted(*a, *b)
            return (mk, mc, mf, mb, np.uint32(len(mk)))
        # both operands end up power-of-two sized (the stored side
        # by its ready n, the fresh side by shape alone — no
        # readback) so merge shape pairs repeat across the build:
        # every new shape pair costs a full XLA compile
        a = _pad_part(self._trim(stored)[:4], _pow2(ns))
        b = _pad_part(fresh[:4], _pow2(fresh[0].shape[0]))
        mkeys, mcov, mfw, mbw, nm = K.merge_sorted(*a, *b)
        return self.async_part((mkeys, mcov, mfw, mbw), nm)

    def push(self, part):
        # retrim every stored level first: their counts are
        # host-ready one push after creation, and untrimmed merge
        # outputs would otherwise hold HBM at 2x-6x their content
        # (a high-coverage level keeps ~n_genome real rows in a
        # sum-of-chunk-sizes buffer)
        levels = self.levels
        for j, lv in enumerate(levels):
            if lv is not None:
                levels[j] = self._trim(lv)
        i = 0
        while True:
            if i == len(levels):
                levels.append(part)
                return
            if levels[i] is None:
                levels[i] = part
                return
            part = self.merge(levels[i], part)
            levels[i] = None
            i += 1

    def finalize(self):
        """Reduce the remaining levels to one part (or None when no
        part was ever pushed)."""
        acc = None
        for part in self.levels:
            if part is None:
                continue
            # both sides are stored parts here: trim both (ready ns)
            acc = part if acc is None else self.merge(acc,
                                                      self._trim(part))
        self.levels = []
        return acc

    def finalize_host(self):
        """finalize() materialized to trimmed host arrays, or None."""
        acc = self.finalize()
        if acc is None:
            return None
        n = int(acc[4])
        return tuple(np.asarray(a)[:n] for a in acc[:4])


class ShardedCounter:
    """SPMD chunk counter over a device mesh, drainable at chunk-batch
    boundaries (extracted from _from_reads_sharded in round 5 so the
    checkpointed builder can emit per-batch parts while reusing the
    compiled sharded count program across batches).

    add() accumulates packed 2-bit chunk buffers and dispatches a
    sharded count per device-group; drain() reduces the per-shard
    tree levels to ONE sorted host table and resets the levels (the
    count program and mesh survive for the next batch)."""

    def __init__(self, mesh, k: int, chunk: int):
        from ..parallel.sharded import sharded_count_fn

        self.mesh = mesh
        self.k = k
        self.chunk = chunk
        self.n = mesh.devices.size
        self.count = sharded_count_fn(mesh, k)
        self.count_full = None  # full-size-bin fallback, on first drop
        self.shard_levels = [[] for _ in range(self.n)]
        self.bufs = []

    def _merge(self, a, b):
        from ..ops import kmers as K

        a = _pad_part(a, _pow2(a[0].shape[0]))
        b = _pad_part(b, _pow2(b[0].shape[0]))
        mkeys, mcov, mfw, mbw, nm = K.merge_sorted(*a, *b)
        nm = int(nm)
        return (mkeys[:nm], mcov[:nm], mfw[:nm], mbw[:nm])

    def _push(self, s, part):
        lv = self.shard_levels[s]
        i = 0
        while True:
            if i == len(lv):
                lv.append(part)
                return
            if lv[i] is None:
                lv[i] = part
                return
            part = self._merge(lv[i], part)
            lv[i] = None
            i += 1

    def _flush(self):
        import jax.numpy as jnp

        bufs, n, chunk = self.bufs, self.n, self.chunk
        if not bufs:
            return
        while len(bufs) < n:
            bufs.append(np.full(len(bufs[0]), 4, np.uint8))
        width = max(len(b) for b in bufs)
        if width < chunk:
            width = chunk  # keep shapes static across flushes
        block = np.full((n, width), 4, np.uint8)
        for i, b in enumerate(bufs):
            block[i, :len(b)] = b
        tkeys, tcov, tfw, tbw, nv, drop = self.count(jnp.asarray(block))
        if int(drop[0]):
            # capacity-factor bins overflowed (skewed keys): retry
            # the block with full-size bins, which cannot drop
            from ..parallel.sharded import sharded_count_fn
            from ..utils import log

            log.verbose(
                f"sharded routing overflow ({int(drop[0])} records); "
                "retrying block with full-size bins")
            if self.count_full is None:
                self.count_full = sharded_count_fn(self.mesh, self.k,
                                                   full_bins=True)
            tkeys, tcov, tfw, tbw, nv, drop = self.count_full(
                jnp.asarray(block))
            assert int(drop[0]) == 0
        for s in range(n):
            m = int(nv[s])
            self._push(s, (tkeys[s, :m], tcov[s, :m], tfw[s, :m],
                           tbw[s, :m]))
        bufs.clear()

    def add(self, buf) -> None:
        self.bufs.append(buf)
        if len(self.bufs) == self.n:
            self._flush()

    def drain(self):
        """Sorted host (keys, cov, fw, bw) of everything added since
        the last drain, or None; resets the tree levels."""
        self._flush()
        shard_tables = []
        for s in range(self.n):
            acc = None
            for part in self.shard_levels[s]:
                if part is None:
                    continue
                acc = part if acc is None else self._merge(acc, part)
            if acc is not None:
                shard_tables.append(tuple(np.asarray(a) for a in acc))
        self.shard_levels = [[] for _ in range(self.n)]
        if not shard_tables:
            return None
        keys = np.concatenate([t[0] for t in shard_tables])
        cov = np.concatenate([t[1] for t in shard_tables])
        fw = np.concatenate([t[2] for t in shard_tables])
        bw = np.concatenate([t[3] for t in shard_tables])
        order = np.argsort(keys, kind="stable")
        return keys[order], cov[order], fw[order], bw[order]


@dataclass
class TableStats:
    total: int
    unique: int
    distinct: int
    edges: int
    histogram: Dict[int, int]

    def missing(self, k: int) -> int:
        return 4 ** k - self.distinct


@dataclass
class KmerTable:
    """Sorted unique k-mer table (host numpy; device cache on demand)."""

    k: int
    keys: np.ndarray  # u64 [n], sorted ascending
    cov: np.ndarray  # u32 [n]
    fw: np.ndarray  # u32 [n, 4]
    bw: np.ndarray  # u32 [n, 4]
    _device: Optional[tuple] = field(default=None, repr=False)
    _bucket: Optional[tuple] = field(default=None, repr=False)
    # out-of-core windowing state: (window_index, arrays) — only ONE
    # window is device-resident at a time (HBM analog of the
    # reference's map-range paging, src/kreeq.cpp:59-76)
    _win_device: Optional[tuple] = field(default=None, repr=False)
    _win_bucket: Optional[tuple] = field(default=None, repr=False)

    @classmethod
    def empty(cls, k: int) -> "KmerTable":
        return cls(k, np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                   np.zeros((0, 4), np.uint32), np.zeros((0, 4), np.uint32))

    def __len__(self) -> int:
        return len(self.keys)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_reads(cls, read_files: Iterable[str], k: int,
                   chunk: int | None = None, mesh=None) -> "KmerTable":
        """Count canonical k-mers of all reads on device.

        `chunk` defaults to the KREEQ_TPU_CHUNK env var (bases per
        device dispatch), falling back to 8M.

        Device pipeline per chunk: kmer_positions -> count_sorted; the
        per-chunk unique tables are reduced by pairwise device merges
        (replaces reference build phase, src/graph-builder.cpp:34-223).

        With `mesh` (or automatically when several devices are
        attached), chunks are counted by the SPMD sharded pipeline:
        records route to owner shards by all_to_all and each device builds
        its sub-table (see kreeq_tpu/parallel/sharded.py).
        """
        import jax
        import jax.numpy as jnp

        from ..io.fastx import iter_reads
        from ..ops import kmers as K

        if chunk is None:
            chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
        read_files = list(read_files)
        if mesh is None and len(jax.devices()) > 1:
            # auto-shard only when the workload amortizes the SPMD
            # dispatch (tiny inputs are faster single-device);
            # KREEQ_TPU_FORCE_SHARDED=1 overrides for parity tests
            try:
                total = sum(os.path.getsize(p) for p in read_files)
            except (OSError, TypeError):
                total = 0
            if (total > 8 * chunk
                    or os.environ.get("KREEQ_TPU_FORCE_SHARDED") == "1"):
                from ..parallel.sharded import make_mesh

                mesh = make_mesh()
        ckpt = os.environ.get("KREEQ_TPU_BUILD_CKPT")
        if ckpt:
            # resumable build: chunk-batch parts + merge manifest on
            # disk, so a mid-build death resumes instead of restarting
            from .build_ckpt import from_reads_checkpointed

            return from_reads_checkpointed(read_files, k, ckpt,
                                           chunk=chunk, mesh=mesh)
        if mesh is not None and mesh.devices.size > 1:
            return cls._from_reads_sharded(read_files, k, chunk, mesh)

        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        # tree-merge chunk tables: pairwise device merges of similarly
        # sized partials keep each merge O(size) instead of rescanning
        # an ever-growing accumulator per chunk (policy: TreeMerger)
        from ..utils import log

        tm = TreeMerger()

        for i, buf in enumerate(K.pack_reads(read_iter(), k, chunk)):
            keys, _isfw, edges, valid = K.kmer_positions(jnp.asarray(buf), k)
            ukeys, cov, fw, bw, n = K.count_sorted(keys, edges, valid)
            tm.push(tm.async_part((ukeys, cov, fw, bw), n))
            if log.verbose_flag:
                log.verbose(f"counted chunk {i} ({int(n)} distinct)")

        acc = tm.finalize_host()
        if acc is None:
            return cls.empty(k)
        return cls(k, *acc)

    @classmethod
    def _from_reads_sharded(cls, read_files, k: int, chunk: int,
                            mesh) -> "KmerTable":
        """SPMD build: per-super-chunk sharded count + per-shard
        tree-merge, final host k-way concat (shards are disjoint)."""
        from ..io.fastx import iter_reads
        from ..ops import kmers as K

        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        sc = ShardedCounter(mesh, k, chunk)
        for buf in K.pack_reads(read_iter(), k, chunk):
            sc.add(buf)
        acc = sc.drain()
        if acc is None:
            return cls.empty(k)
        return cls(k, *acc)

    @classmethod
    def from_entries(cls, k: int, entries: Dict[int, tuple]) -> "KmerTable":
        """Build from {key: (fw0..fw3, bw0..bw3, cov)} host entries."""
        if not entries:
            return cls.empty(k)
        keys = np.fromiter(entries.keys(), np.uint64, len(entries))
        order = np.argsort(keys, kind="stable")
        vals = np.array(list(entries.values()), np.uint32)[order]
        return cls(k, keys[order], vals[:, 8].copy(),
                   vals[:, 0:4].copy(), vals[:, 4:8].copy())

    def merge(self, other: "KmerTable") -> "KmerTable":
        """Union with saturating adds (replaces `kreeq union`,
        reference: src/graph-builder.cpp:297-351)."""
        import jax
        import jax.numpy as jnp

        from ..ops import kmers as K

        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        if len(jax.devices()) > 1 and (
                os.environ.get("KREEQ_TPU_FORCE_SHARDED") == "1"
                or len(self) + len(other) > (1 << 23)):
            return self.merge_sharded(other)
        if len(self) + len(other) > _host_merge_threshold():
            # out-of-core union: device HBM can't hold operands +
            # output + sort workspace
            return KmerTable(self.k, *host_merge_sorted(
                self.keys, self.cov, self.fw, self.bw,
                other.keys, other.cov, other.fw, other.bw))
        a = _pad_part((jnp.asarray(self.keys), jnp.asarray(self.cov),
                       jnp.asarray(self.fw), jnp.asarray(self.bw)),
                      _pow2(len(self)))
        b = _pad_part((jnp.asarray(other.keys), jnp.asarray(other.cov),
                       jnp.asarray(other.fw), jnp.asarray(other.bw)),
                      _pow2(len(other)))
        mkeys, mcov, mfw, mbw, n = K.merge_sorted(*a, *b)
        n = int(n)
        return KmerTable(self.k, *(np.asarray(a[:n]) for a in
                                   (mkeys, mcov, mfw, mbw)))

    def merge_sharded(self, other: "KmerTable", mesh=None) -> "KmerTable":
        """Union across a device mesh: key-range partition both sorted
        tables on the host (a shard's slice pair is contiguous), merge
        each slice pair on its device (no inter-device traffic — the
        SPMD analog of the reference's submap-parallel mergeMaps,
        src/graph-builder.cpp:338-432), and concatenate the disjoint
        ascending per-shard results."""
        import jax.numpy as jnp

        from ..ops.kmers import SENTINEL
        from ..parallel.sharded import make_mesh, sharded_merge_fn

        if mesh is None:
            mesh = make_mesh()
        n = int(mesh.devices.size)
        # range boundaries = quantiles of the larger table's keys; any
        # boundaries are correct (searchsorted-left on both sides sends
        # every key — including one present in both tables — to exactly
        # one shard), balance only affects padding
        src = self.keys if len(self) >= len(other) else other.keys
        bnd = src[(np.arange(1, n) * len(src)) // n]
        ai = np.concatenate(([0], np.searchsorted(self.keys, bnd),
                             [len(self)]))
        bi = np.concatenate(([0], np.searchsorted(other.keys, bnd),
                             [len(other)]))
        rows = _pow2(max(int(np.max(ai[1:] - ai[:-1])),
                         int(np.max(bi[1:] - bi[:-1])), 1))
        sent = np.uint64(SENTINEL)

        def stack(t, idx):
            ks = np.full((n, rows), sent, np.uint64)
            cv = np.zeros((n, rows), np.uint32)
            fw = np.zeros((n, rows, 4), np.uint32)
            bw = np.zeros((n, rows, 4), np.uint32)
            for d in range(n):
                lo, hi = int(idx[d]), int(idx[d + 1])
                m = hi - lo
                ks[d, :m] = t.keys[lo:hi]
                cv[d, :m] = t.cov[lo:hi]
                fw[d, :m] = t.fw[lo:hi]
                bw[d, :m] = t.bw[lo:hi]
            return ks, cv, fw, bw

        step = sharded_merge_fn(mesh)
        out = step(*(jnp.asarray(x) for x in
                     stack(self, ai) + stack(other, bi)))
        mk, mc, mf, mb, nm = (np.asarray(x) for x in out)
        keep = [slice(0, int(nm[d])) for d in range(n)]
        return KmerTable(
            self.k,
            np.concatenate([mk[d][keep[d]] for d in range(n)]),
            np.concatenate([mc[d][keep[d]] for d in range(n)]),
            np.concatenate([mf[d][keep[d]] for d in range(n)]),
            np.concatenate([mb[d][keep[d]] for d in range(n)]))

    # -- probing -----------------------------------------------------------

    @staticmethod
    def max_device_rows() -> int:
        """Row cap for one device-resident table window.

        KREEQ_TPU_MAX_TABLE_ROWS overrides (tests force tiny caps to
        exercise windowing).  The default budgets ~45% of device memory
        for the table (44 B/row: u64 key + 9xu32 payload), leaving the
        rest for probe workspace (join sorts scale with t + q) — the
        device analog of the reference's maxMem map-range budget
        (reference: src/main.cpp:433, src/kreeq.cpp:59-76).  Device
        memory is the allocator's `bytes_limit`; the CPU backend
        reports none and sizes from host memory.  An accelerator that
        reports no limit is an error: a guessed size could overrun it.
        """
        env = os.environ.get("KREEQ_TPU_MAX_TABLE_ROWS")
        if env:
            return max(int(env), 1)
        import jax

        dev = jax.devices()[0]
        mem = (dev.memory_stats() or {}).get("bytes_limit", 0)
        if not mem:
            if dev.platform != "cpu":
                raise RuntimeError(
                    f"device {dev.device_kind!r} reports no memory "
                    "limit; set KREEQ_TPU_MAX_TABLE_ROWS")
            mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return max(int(mem * 0.45) // 44, 1 << 20)

    def window_ranges(self):
        """Row ranges [(lo, hi), ...] of the out-of-core windows, or
        None when the whole table fits one window (the common case —
        paging collapses to a no-op, SURVEY.md P3)."""
        n = len(self)
        cap = self.max_device_rows()
        if n <= cap:
            return None
        w = -(-n // cap)
        step = -(-n // w)
        return [(i * step, min(n, (i + 1) * step)) for i in range(w)]

    def _upload(self, lo: int, hi: int):
        """SENTINEL-padded device copy of rows [lo, hi).

        Padding to the {2^i, 1.5*2^i} grid (<= 33% rows, probes handle
        SENTINEL rows exactly) makes every downstream probe program's
        shape a function of the slice's size BUCKET, not its exact
        row count — an exact-sized table would recompile every probe
        program for every freshly built DB.
        """
        import jax.numpy as jnp

        from ..ops.kmers import SENTINEL

        n = hi - lo
        size = 64
        while size < n:
            size *= 2
        if n <= size // 4 * 3 and size // 4 * 3 >= 64:
            size = size // 4 * 3
        pad = size - n
        keys, cov, fw, bw = (self.keys[lo:hi], self.cov[lo:hi],
                             self.fw[lo:hi], self.bw[lo:hi])
        if pad:
            keys = np.concatenate(
                [keys, np.full(pad, np.uint64(SENTINEL), np.uint64)])
            cov = np.concatenate([cov, np.zeros(pad, np.uint32)])
            fw = np.concatenate([fw, np.zeros((pad, 4), np.uint32)])
            bw = np.concatenate([bw, np.zeros((pad, 4), np.uint32)])
        return (jnp.asarray(keys), jnp.asarray(cov),
                jnp.asarray(fw), jnp.asarray(bw))

    def device_arrays(self, window: int | None = None):
        """Device copies (SENTINEL-padded).  With `window=i`, returns
        window i's rows only; a single window is resident at a time
        (uploading window i+1 frees window i's HBM)."""
        if window is None:
            if self._device is None:
                self._device = self._upload(0, len(self))
            return self._device
        ranges = self.window_ranges()
        assert ranges is not None
        if self._win_device is None or self._win_device[0] != window:
            self._win_device = None  # drop the old window's HBM first
            self._win_bucket = None
            lo, hi = ranges[window]
            self._win_device = (window, self._upload(lo, hi))
        return self._win_device[1]

    def _build_bucket(self, tkeys, nrows: int):
        import math

        import jax.numpy as jnp

        from ..ops.kmers import build_bucket_index

        n = max(nrows, 2)
        # one bit past table size: mean bucket occupancy ~0.5, so
        # bisection needs only ~log2(max Poisson bucket) ~ 3 rounds
        # (each round is a full-batch HBM gather — the probe's
        # dominant cost)
        bits = min(max(8, math.ceil(math.log2(n)) + 1), 24, 2 * self.k)
        starts = build_bucket_index(tkeys, self.k, bits)
        # the device slice is SENTINEL-tail padded; cap bucket ends at
        # the real row count so the tail neither inflates the last
        # bucket nor the bisection round bound
        starts = jnp.minimum(starts, nrows)
        counts = np.diff(np.asarray(starts))
        rounds = max(1, int(np.ceil(np.log2(counts.max() + 1))))
        return starts, bits, rounds

    def bucket_index(self, window: int | None = None):
        """(starts, bits, rounds) for the bucketed probe.

        NOTE: with windows, bisection brackets come from searchsorted
        over the window slice, so out-of-range keys simply never match
        — no extra masking needed."""
        if window is None:
            if self._bucket is None:
                self._bucket = self._build_bucket(self.device_arrays()[0],
                                                  len(self))
            return self._bucket
        if self._win_bucket is None or self._win_bucket[0] != window:
            ranges = self.window_ranges()
            lo, hi = ranges[window]
            tkeys = self.device_arrays(window)[0]
            self._win_bucket = (window,
                                self._build_bucket(tkeys, hi - lo))
        return self._win_bucket[1]

    def _probe_one(self, arrays, q, bucket):
        """One probe against one device-resident (sub)table."""
        from ..ops import kmers as K

        tkeys, cov, fw, bw = arrays
        if tkeys.shape[0] <= 6 * q.shape[0]:
            # sort-merge join: cost ~ (t + q), chosen over the
            # bisection's per-round gathers when the table is not much
            # larger than the batch
            return K.probe_merge(tkeys, cov, fw, bw, q)
        starts, bits, rounds = bucket()
        return K.probe_bucketed(tkeys, cov, fw, bw, starts, q, self.k,
                                bits, rounds)

    def probe_device(self, q):
        """Device-level lookup (found, cov, fw, bw) as device arrays;
        transparently pages table windows when the table exceeds the
        device cap (each window probes the full batch; disjoint key
        ranges mean at most one window finds any query)."""
        ranges = self.window_ranges()
        if ranges is None:
            return self._probe_one(self.device_arrays(), q,
                                   self.bucket_index)
        from ..ops.kmers import combine_probe

        acc = None
        for w in range(len(ranges)):
            arrays = self.device_arrays(w)
            res = self._probe_one(arrays, q,
                                  lambda w=w: self.bucket_index(w))
            acc = res if acc is None else combine_probe(*acc, *res)
        return acc

    def probe(self, qkeys) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """Vectorized lookup: (found, cov, fw[.,4], bw[.,4])."""
        import jax.numpy as jnp

        if len(self) == 0:
            q = np.asarray(qkeys)
            return (np.zeros(len(q), bool), np.zeros(len(q), np.uint32),
                    np.zeros((len(q), 4), np.uint32),
                    np.zeros((len(q), 4), np.uint32))
        found, qcov, qfw, qbw = self.probe_device(jnp.asarray(qkeys))
        return (np.asarray(found), np.asarray(qcov), np.asarray(qfw),
                np.asarray(qbw))

    def lookup(self, key: int):
        """Scalar host lookup: (fw[4], bw[4], cov) or None."""
        i = np.searchsorted(self.keys, np.uint64(key))
        if i < len(self.keys) and self.keys[i] == np.uint64(key):
            return self.fw[i], self.bw[i], int(self.cov[i])
        return None

    # -- statistics --------------------------------------------------------

    def stats(self) -> TableStats:
        """DBG summary numbers (reference: src/graph-builder.cpp:240-295).

        "Total edges" reproduces the reference's ternary-precedence
        accident: an edge slot counts once if either the fw or bw
        counter is non-zero (reference: src/graph-builder.cpp:253-254).
        """
        distinct = len(self.keys)
        total = int(self.cov.astype(np.uint64).sum())
        unique = int((self.cov == 1).sum())
        edges = int(((self.fw > 0) | (self.bw > 0)).sum())
        vals, counts = np.unique(self.cov, return_counts=True)
        hist = {int(v): int(c) for v, c in zip(vals, counts)}
        return TableStats(total, unique, distinct, edges, hist)
