"""Multi-host (multi-process) distributed build and probe.

The reference scales across machines by building one .kreeq DB per job
and merging them serially with `kreeq union` through the filesystem
(reference: README.md:31-39, src/graph-builder.cpp:297-351).  The
replacement here runs ONE SPMD program over a global device mesh
spanning all hosts (`jax.distributed`): every host streams its shard of
the read files, records route to their owner device with all_to_all
(device links within a host, the network across hosts), and each
device keeps
the sub-table for keys it owns (mixed-hash ownership, sharded.owner_of).
Shards are disjoint, so the cross-host "union" needs no data movement
at all — it happens implicitly during routing.

Host-side lockstep: collective programs must be entered the same number
of times by every process, but hosts own different numbers of read
chunks.  Before each round, hosts agree with a tiny host-side allgather
whether anyone still has data; exhausted hosts feed BAD-filled blocks
(zero k-mers) until all are done.

CPU-testable: `jax.distributed.initialize` + gloo collectives work on
multi-process virtual CPU meshes (tests/test_multihost.py proves
bitwise equality with the single-process build on a 2-process mesh).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import numpy as np

_COORD_ENV = "KREEQ_TPU_COORDINATOR"  # host:port of process 0
_NPROCS_ENV = "KREEQ_TPU_NUM_PROCESSES"
_PID_ENV = "KREEQ_TPU_PROCESS_ID"


def maybe_initialize() -> bool:
    """Initialize jax.distributed from KREEQ_TPU_* env vars if set.

    Returns True when running multi-process.  Call before any backend
    use (the CLI does this at startup).  The env vars give
    `jax.distributed.initialize()` its coordinator, process count and
    process id explicitly.
    """
    import jax

    coord = os.environ.get(_COORD_ENV)
    if coord is None:
        return False
    nprocs = int(os.environ[_NPROCS_ENV])
    pid = int(os.environ[_PID_ENV])
    if nprocs <= 1:
        return False
    # NB: do not touch jax.default_backend() here — that would
    # initialize backends before jax.distributed.initialize runs
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS", ""))
    if "cpu" in str(platforms):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nprocs, process_id=pid)
    return True


def shard_read_files(files: Iterable[str], num_processes: int,
                     process_id: int) -> List[str]:
    """Deterministic per-host slice of the input read files.

    Round-robin by position (reference analog: one read set per HPC
    job, README.md:31-39).  Hosts may receive zero files; the lockstep
    build handles that.
    """
    return [f for i, f in enumerate(files) if i % num_processes ==
            process_id]


def _host_flags(flag: bool) -> np.ndarray:
    """Host-side allgather of one bool per process (tiny, DCN)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(
        np.array([flag], np.int32))).reshape(-1)


def build_table_distributed(read_files, k: int,
                            chunk: Optional[int] = None,
                            mesh=None) -> "KmerTable":
    """Count k-mers of `read_files` across all hosts; return the FULL
    table, identical on every host.

    `read_files` is the per-host slice (see shard_read_files) — pass
    each host its own files.  The result is bitwise identical to a
    single-process KmerTable.from_reads over the union of all hosts'
    files (tests/test_multihost.py).
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core.table import KmerTable, _pad_part, _pow2
    from ..io.fastx import iter_reads
    from ..ops import kmers as K
    from .sharded import AXIS, make_mesh, sharded_count_fn

    if chunk is None:
        chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    local_n = jax.local_device_count()
    # shard index == position along the mesh axis (NOT device.id)
    dev_pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    local_shards = sorted(dev_pos[d] for d in jax.local_devices())
    sharding = NamedSharding(mesh, P(AXIS))

    count = sharded_count_fn(mesh, k)
    count_full = None

    def read_iter():
        for path in read_files:
            yield from iter_reads(path)

    def merge(a, b):
        a = _pad_part(a, _pow2(a[0].shape[0]))
        b = _pad_part(b, _pow2(b[0].shape[0]))
        mkeys, mcov, mfw, mbw, nm = K.merge_sorted(*a, *b)
        nm = int(nm)
        return (mkeys[:nm], mcov[:nm], mfw[:nm], mbw[:nm])

    shard_levels = {s: [] for s in local_shards}

    def push(s, part):
        lv = shard_levels[s]
        i = 0
        while True:
            if i == len(lv):
                lv.append(part)
                return
            if lv[i] is None:
                lv[i] = part
                return
            part = merge(lv[i], part)
            lv[i] = None
            i += 1

    def dispatch(block):
        nonlocal count_full
        garr = jax.make_array_from_process_local_data(sharding, block)
        tkeys, tcov, tfw, tbw, nv, drop = count(garr)
        if int(np.asarray(drop.addressable_shards[0].data)[0]):
            from ..utils import log

            log.verbose("sharded routing overflow; retrying block with "
                        "full-size bins")
            if count_full is None:
                count_full = sharded_count_fn(mesh, k, full_bins=True)
            tkeys, tcov, tfw, tbw, nv, drop = count_full(garr)
            assert int(np.asarray(drop.addressable_shards[0].data)[0]) == 0
        nv_local = {sh.index[0].start: int(np.asarray(sh.data)[0])
                    for sh in nv.addressable_shards}
        arrs = {}
        for name, arr in (("k", tkeys), ("c", tcov), ("f", tfw),
                          ("b", tbw)):
            arrs[name] = {sh.index[0].start: np.asarray(sh.data)[0]
                          for sh in arr.addressable_shards}
        for s in local_shards:
            m = nv_local[s]
            push(s, (arrs["k"][s][:m], arrs["c"][s][:m],
                     arrs["f"][s][:m], arrs["b"][s][:m]))

    chunks = K.pack_reads(read_iter(), k, chunk)
    bufs: List[np.ndarray] = []
    done = False
    while True:
        # fill this host's rows for the round
        while not done and len(bufs) < local_n:
            try:
                buf = next(chunks)
            except StopIteration:
                done = True
                break
            if len(buf) > chunk:
                raise ValueError(
                    "multi-host build requires chunk >= longest read "
                    f"({len(buf)} > {chunk}); raise KREEQ_TPU_CHUNK")
            bufs.append(buf)
        have = len(bufs) > 0
        flags = _host_flags(have)
        if not flags.any():
            break
        block = np.full((local_n, chunk), 4, np.uint8)
        for i, b in enumerate(bufs):
            block[i, :len(b)] = b
        bufs.clear()
        dispatch(block)

    # per-shard accumulated tables -> host arrays
    local_tables = {}
    for s in local_shards:
        acc = None
        for part in shard_levels[s]:
            if part is None:
                continue
            acc = part if acc is None else merge(acc, part)
        if acc is None:
            acc = (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                   np.zeros((0, 4), np.uint32), np.zeros((0, 4), np.uint32))
        local_tables[s] = tuple(np.asarray(a) for a in acc)

    # gather every shard to every host (shards are disjoint; the full
    # table is the sorted concat).  Sizes differ per shard, so exchange
    # through a padded [n, maxlen, 11] u32 block.
    sizes = np.zeros(n, np.int64)
    for s, t in local_tables.items():
        sizes[s] = len(t[0])
    sizes = np.asarray(multihost_utils.process_allgather(sizes)).reshape(
        -1, n).max(axis=0)
    maxlen = max(int(sizes.max()), 1)
    packed = np.zeros((len(local_shards), maxlen, 11), np.uint32)
    for i, s in enumerate(local_shards):
        keys, cov, fw, bw = local_tables[s]
        m = len(keys)
        packed[i, :m, 0] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        packed[i, :m, 1] = (keys >> np.uint64(32)).astype(np.uint32)
        packed[i, :m, 2] = cov
        packed[i, :m, 3:7] = fw
        packed[i, :m, 7:11] = bw
    gathered = np.asarray(multihost_utils.process_allgather(
        packed, tiled=True)).reshape(n, maxlen, 11)
    # row order after the tiled gather is process-major; map back to
    # global shard indices explicitly rather than assuming they match
    shard_ids = np.asarray(multihost_utils.process_allgather(
        np.asarray(local_shards, np.int64), tiled=True)).reshape(-1)
    row_of = {int(s): i for i, s in enumerate(shard_ids)}

    parts_k, parts_c, parts_f, parts_b = [], [], [], []
    for s in range(n):
        m = int(sizes[s])
        row = gathered[row_of[s], :m]
        keys = (row[:, 0].astype(np.uint64)
                | (row[:, 1].astype(np.uint64) << np.uint64(32)))
        parts_k.append(keys)
        parts_c.append(row[:, 2])
        parts_f.append(row[:, 3:7])
        parts_b.append(row[:, 7:11])
    keys = np.concatenate(parts_k)
    order = np.argsort(keys, kind="stable")
    return KmerTable(k, keys[order],
                     np.concatenate(parts_c)[order],
                     np.concatenate(parts_f)[order],
                     np.concatenate(parts_b)[order])
