"""Candidate-error discovery: bounded read-graph search per assembly
position (reference: src/variants.cpp).

For every unexplained assembly k-mer, a bounded search walks the read
DBG from the last good k-mer toward a sliding window of downstream
"target" k-mers; a reconnection classifies the divergence as
SNV/INS/DEL/COM and reconstructs the alternative sequence by
backtracking (reference: src/variants.cpp:171-310).  The search
replicates the reference's quirks exactly:

  * only the bw-side edge test applies the coverage cutoff
    (ternary-precedence accident, reference: src/variants.cpp:236),
  * depth counts extracted nodes (<= kmerDepth+1 expansions),
  * destinations are capped at 10, the heap at 1000 nodes,
  * queued nodes keep priority 0 (decreaseKey refuses to raise keys),
    so extraction order follows the Fibonacci-heap mechanics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..constants import revcom
from .fibheap import FibonacciHeap
from .keys import canonical, key_to_seq, next_key_bw, next_key_fw

SNV, INS, DEL, COM = "SNV", "INS", "DEL", "COM"


@dataclass
class DBGpath:
    """Reference: gfalibs DBGpath {type, pos, sequence, refLen}."""

    type: str = SNV
    pos: int = 0
    sequence: str = ""
    ref_len: int = 1


def correct_sequences(dbg, out=None) -> None:
    """Serial per segment (reference: src/variants.cpp:40-51)."""
    if not dbg.ui.in_sequence:
        return
    from ..config import get_file_ext

    ext = get_file_ext("." + dbg.ui.out_file)
    to_gfa = ext in ("gfa", "gfa2", "gfa.gz", "gfa2.gz")
    for seg in list(dbg.genome.segments):
        dbg_to_variants(dbg, seg)
        if to_gfa:
            variants_to_gfa(dbg, seg)


def detect_anomalies(dbg, seg) -> List[Tuple[int, int]]:
    """Flag positions whose k-mer is missing or whose forward edge to
    the next assembly base is absent (reference:
    src/variants.cpp:406-456 — legacy code whose output is pinned by
    testFiles/random1.anomalies.bed).  Returns merged 1-based inclusive
    ranges of anomalous k-mer start positions."""
    k = dbg.k
    ln = len(seg)
    if ln < k:
        return []
    kcount = ln - k + 1
    codes = seg.codes
    table = dbg.table

    import numpy as np

    from ..ops.kmers import kmer_positions

    import jax.numpy as jnp

    keys, isfw, _edges, valid = kmer_positions(jnp.asarray(codes), k)
    keys = np.asarray(keys)
    isfw = np.asarray(isfw)
    valid = np.asarray(valid)
    found, _cov, rfw, rbw = table.probe(keys)
    # non-ACGT bases are masked to code 0 inside keys; the reference's
    # hash of a code>3 base misses the DB, so an invalid k-mer is never
    # "found" (mirrors validate_positions' found & valid guard)
    found = found & valid

    nxt = codes[k:].astype(np.int64)  # next base per position c<kcount-1
    bad_next = nxt > 3  # IUPAC codes: skip the continuity test
    nxt = nxt & 3
    pos = np.arange(kcount - 1)
    fw_edge = rfw[pos, nxt]
    bw_edge = rbw[pos, 3 - nxt]
    cont_missing = (np.where(isfw[:-1], fw_edge, bw_edge) == 0) & ~bad_next
    anomaly = ~found[:kcount]
    anomaly[:-1] |= found[:kcount - 1] & cont_missing
    anomalies = np.nonzero(anomaly)[0].tolist()

    ranges: List[Tuple[int, int]] = []
    for c in anomalies:
        if ranges and c == ranges[-1][1]:
            ranges[-1] = (ranges[-1][0], c + 1)
        else:
            ranges.append((c, c + 1))
    return [(a + 1, b) for a, b in ranges]


def write_anomalies(dbg, out_path: str) -> None:
    with open(out_path, "w") as fh:
        for seg, path in zip(dbg.genome.segments,
                             _segment_paths(dbg.genome)):
            for a, b in detect_anomalies(dbg, seg):
                fh.write(f"{path}\t{a}\t{b}\n")


def _segment_paths(genome):
    """Path header owning each segment, in segment order."""
    owner = {}
    for path in genome.paths:
        for comp in path.components:
            if comp.ctype == "S":
                owner[comp.id] = path.header
    return [owner.get(seg.uid, seg.header) for seg in genome.segments]


def variants_to_gfa(dbg, seg) -> None:
    """Split a segment at variant sites into a bubble graph
    (reference: src/variants.cpp:312-404)."""
    from ..io.sequence import Edge

    genome = dbg.genome
    old = seg.seq
    header = seg.header
    seq_pos = seg.seq_pos
    processed = 0
    segment_counter = 0
    edge_counter = 0
    s_uids: List[int] = []
    s_uid = None

    def add_seg(name: str, sub: str):
        return genome.add_segment(name, sub, seq_pos=seq_pos)

    def add_edge(a: int, b: int) -> None:
        nonlocal edge_counter
        edge_counter += 1
        genome.add_edge(Edge(genome.next_uid(), len(genome.edges), a, b,
                             "+", "+", "0M",
                             f"{header}.edge.{edge_counter}"))

    for group in seg.variants:
        pos0 = group[0].pos
        segment_counter += 1
        new_seg = add_seg(f"{header}.{segment_counter}",
                          old[processed:pos0])
        for prev_uid in s_uids:
            add_edge(prev_uid, new_seg.uid)
        s_uids = []
        s_uid = new_seg.uid
        alt_counter = 0
        original_added = False
        processed = pos0
        for var in group:
            if var.type != DEL and not original_added:
                segment_counter += 1
                orig = add_seg(f"{header}.{segment_counter}",
                               old[pos0:pos0 + 1])
                add_edge(s_uid, orig.uid)
                s_uids.append(orig.uid)
                original_added = True
                processed += 1
            if var.type in (SNV, DEL):
                alt_counter += 1
                alt = add_seg(
                    f"{header}.{segment_counter}.alt{alt_counter}",
                    var.sequence)
                s_uids.append(alt.uid)
            if var.type == SNV:
                add_edge(s_uid, alt.uid)
            elif var.type == INS:
                s_uids.append(s_uid)
            elif var.type == DEL:
                add_edge(s_uid, alt.uid)
                s_uids.append(s_uid)
    if seg.variants:
        segment_counter += 1
        tail = add_seg(f"{header}.{segment_counter}", old[processed:])
        for prev_uid in s_uids:
            add_edge(prev_uid, tail.uid)
        genome.delete_segment(header)


def _extract_sentinel(codes, k: int):
    """K-mer extraction with per-position sentinels for invalid
    windows (traced; shared by the fused and windowed scan paths).

    Non-ACGT windows: the reference hashes garbage bytes into a
    key that misses the DB; a distinct per-position sentinel
    mirrors that.  For k < 32 a high-bit sentinel cannot alias a
    real key (canonical keys are < 4^k <= 2^62).  At k = 32 keys
    span the full 64 bits, so use first-base-T | last-base-T
    values instead: their reverse complement (first-base A at the
    top) is strictly smaller, so no canonical key — table entry,
    valid window, or candidate neighbour — can ever equal one."""
    import jax.numpy as jnp

    from ..ops.kmers import kmer_positions

    p = codes.shape[0] - k + 1
    keys, isfw, _e, valid = kmer_positions(codes, k)
    iota = jnp.arange(p, dtype=jnp.uint64)
    if k < 32:
        sentinels = jnp.uint64(1 << 63) | iota
    else:
        sentinels = (jnp.uint64(3)
                     | (iota << jnp.uint64(2))
                     | (jnp.uint64(3) << jnp.uint64(2 * (k - 1))))
    keys = jnp.where(valid, keys, sentinels)
    return keys, isfw, valid


def _candidate_scan(keys, isfw, found, covs, fws, bws, cutoff, k: int):
    """Depth-0 candidate-edge scan (traced; shared by both paths).
    A neighbour's reverse complement is the source rc shifted one base
    the other way, so one [P] revcomp serves all eight neighbours."""
    import jax.numpy as jnp

    m = jnp.uint64((1 << (2 * k)) - 1)
    x = ((~keys) & m) << jnp.uint64(64 - 2 * k)
    for sh, mm in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                   (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        mm = jnp.uint64(mm)
        x = ((x & mm) << jnp.uint64(sh)) | ((x >> jnp.uint64(sh)) & mm)
    rc = ((x << jnp.uint64(32)) | (x >> jnp.uint64(32))) & m

    bases = jnp.arange(4, dtype=jnp.uint64)[None, :]
    comp = jnp.uint64(3) - bases
    top = jnp.uint64(2 * (k - 1))
    raw_fw = (keys[:, None] >> jnp.uint64(2)) | (bases << top)
    rc_fw = ((rc[:, None] << jnp.uint64(2)) & m) | comp
    raw_bw = ((keys[:, None] << jnp.uint64(2)) & m) | bases
    rc_bw = (rc[:, None] >> jnp.uint64(2)) | (comp << top)
    cand = jnp.where(isfw[:, None],
                     jnp.minimum(raw_fw, rc_fw),
                     jnp.minimum(raw_bw, rc_bw))
    cond = jnp.where(isfw[:, None], fws > 0, bws > cutoff)
    ref_next = jnp.concatenate(
        [keys[1:], jnp.full((1,), 0xFFFFFFFFFFFFFFFF, jnp.uint64)])
    has_candidate = (cond & (cand != ref_next[:, None])).any(axis=1)
    return keys, isfw, found & has_candidate, covs, fws, bws


def _scan_probe_fn():
    """Build the fused device program of dbg_to_variants: k-mer
    extraction, invalid-position sentinels, the batched table probe,
    and the depth-0 candidate scan — ONE dispatch, no intermediate
    host materialization."""
    from functools import partial

    import jax

    from ..ops.kmers import probe_bucketed, probe_merge

    @partial(jax.jit, static_argnums=(7, 8, 9, 10))
    def f(tkeys, tcov, tfw, tbw, starts, codes, cutoff,
          k, use_merge, bits, rounds):
        keys, isfw, valid = _extract_sentinel(codes, k)
        if use_merge:
            found, covs, fws, bws = probe_merge(tkeys, tcov, tfw, tbw,
                                                keys)
        else:
            found, covs, fws, bws = probe_bucketed(
                tkeys, tcov, tfw, tbw, starts, keys, k, bits, rounds)
        return _candidate_scan(keys, isfw, found & valid, covs, fws,
                               bws, cutoff, k)

    return f


def _scan_probe_windowed(table, codes_d, cutoff, k: int):
    """The scan-probe with the table probe routed through the
    out-of-core window pager (KmerTable.probe_device)."""
    from functools import partial

    import jax

    extract = jax.jit(_extract_sentinel, static_argnums=(1,))
    keys, isfw, valid = extract(codes_d, k)
    found, covs, fws, bws = table.probe_device(keys)
    scan = jax.jit(partial(_candidate_scan, k=k))
    return scan(keys, isfw, found & valid, covs, fws, bws, cutoff)


_scan_probe = None


def _variants_window_cap() -> int:
    """Positions per variants-scan window.  KREEQ_TPU_VARIANTS_WINDOW
    overrides (tests force tiny caps to exercise seam handling)."""
    import os

    env = os.environ.get("KREEQ_TPU_VARIANTS_WINDOW")
    return int(env) if env else (1 << 22)


def dbg_to_variants(dbg, seg) -> None:
    """Reference: src/variants.cpp:53-169.

    Batched redesign of the reference's per-position loop: one device
    probe answers every position's source-k-mer lookup, and a
    vectorized depth-0 candidate-edge scan identifies the positions
    whose search would terminate immediately with no discoveries
    (edge_count == explored_count == 0 — the overwhelmingly common
    case on a healthy assembly).  Only true branch points run the exact
    host Fibonacci-heap search, preserving byte-identical output
    (golden test.50) at a fraction of the reference's cost.

    The scan runs in fixed windows of at most _variants_window_cap()
    positions (the reference's analog: map-range paging re-scans,
    src/variants.cpp:75-152), so device memory is bounded regardless
    of segment length.  Window halos make every window byte-exact:
    a RIGHT halo of k+max_span+1 positions covers the targets window
    and the reference-edge key of every core position, and a LEFT halo
    of max_span positions covers the back-occurrence test — in
    targets_state, an occurrence o <= c+k flips a key out of the map
    only when o > a - max_span (a >= c+k+1 being its in-window append
    position), so occurrences older than max_span positions behind the
    window never change the outcome.
    """
    k = dbg.k
    ln = len(seg)
    if ln < k:
        return
    kcount = ln - k + 1
    max_span = dbg.ui.max_span
    cutoff = dbg.ui.cov_cutoff
    table = dbg.table
    codes = seg.codes
    cache: Dict[int, object] = {}
    variants: List[List[DBGpath]] = []

    import numpy as np

    win = _variants_window_cap()
    lh = max_span                 # left halo (positions)
    rh = k + max_span + 1         # right halo (positions)
    from ..utils import log

    wins = []
    for wa in range(0, kcount, win):
        wb = min(wa + win, kcount)
        wins.append((wa, wb, max(0, wa - lh), min(kcount, wb + rh)))
    nwin = len(wins)

    if table.window_ranges() is not None:
        # out-of-core table: INVERTED rescan (reference analog:
        # map-range windows outer, rescan the sequence inner —
        # src/variants.cpp:75-152).  Each table window uploads ONCE;
        # per-sequence-window probe partials combine on the host
        # (window key ranges are disjoint, so at most one window finds
        # any query).  The per-window inner pager (probe_device) would
        # otherwise re-upload EVERY table window per sequence window —
        # ~110 GB for a 100 Mbp segment against a 100M-row table.
        _scan_windows_inverted(dbg, seg, codes, wins, kcount, k,
                               max_span, cutoff, table, cache,
                               variants)
        seg.variants = variants
        return

    for wi, (wa, wb, lo, hi) in enumerate(wins):
        # per-window progress is load-bearing at scale: long-running
        # CLI phases are watchdogged on output cadence by schedulers
        log.verbose(f"variants window {wi + 1}/{nwin} "
                    f"[{wa}, {wb}) of {kcount}")
        _scan_window_variants(dbg, seg, codes, lo, hi, wa, wb, kcount,
                              k, max_span, cutoff, table, cache,
                              variants)
        if log.verbose_flag:
            log.verbose(f"variants window {wi + 1}/{nwin} done "
                        f"({len(variants)} positions with variants)")
    seg.variants = variants


def _win_cbuf(codes, lo: int, hi: int, k: int):
    """BAD-padded pow2 codes buffer feeding positions [lo, hi)."""
    import numpy as np

    nbase = hi - lo + k - 1
    pad = max(64, 1 << int(np.ceil(np.log2(nbase))))
    cbuf = np.full(pad, 4, np.uint8)
    cbuf[:nbase] = codes[lo:lo + nbase]
    return cbuf


def _scan_windows_inverted(dbg, seg, codes, wins, kcount: int, k: int,
                           max_span: int, cutoff: int, table, cache,
                           variants) -> None:
    """Two-pass variants scan for out-of-core tables.

    Pass 1 (table windows OUTER): for each device-resident table
    window, probe every sequence window's keys and fold the partial
    (found, cov, fw, bw) into host accumulators — found masks are
    disjoint across table windows.  Pass 2: per sequence window,
    re-upload the combined probe result, run the depth-0 candidate
    scan on device, and hand off to the host search exactly like the
    in-core path.  Transfers: each table window uploads once + one
    combined re-upload per sequence window, instead of paging the
    table inside every sequence window."""
    from functools import partial as _partial

    import numpy as np

    import jax
    import jax.numpy as jnp

    from ..utils import log

    ranges = table.window_ranges()
    extract = jax.jit(_extract_sentinel, static_argnums=(1,))
    partials = [None] * len(wins)
    for w in range(len(ranges)):
        arrays = table.device_arrays(w)
        for wi, (wa, wb, lo, hi) in enumerate(wins):
            log.verbose(f"variants probe: table window "
                        f"{w + 1}/{len(ranges)}, seq window "
                        f"{wi + 1}/{len(wins)}")
            cbuf = _win_cbuf(codes, lo, hi, k)
            keys, _isfw, valid = extract(jnp.asarray(cbuf), k)
            found, cv, fu, bu = table._probe_one(
                arrays, keys, lambda w=w: table.bucket_index(w))
            found = np.asarray(found) & np.asarray(valid)
            # np.asarray of a device buffer is read-only; later table
            # windows fold into these in place, so materialize copies
            cv, fu, bu = (np.array(x) for x in (cv, fu, bu))
            if partials[wi] is None:
                partials[wi] = [found, cv, fu, bu]
            else:
                acc = partials[wi]
                acc[0] |= found
                acc[1][found] = cv[found]
                acc[2][found] = fu[found]
                acc[3][found] = bu[found]
    scan = jax.jit(_partial(_candidate_scan, k=k))
    for wi, (wa, wb, lo, hi) in enumerate(wins):
        log.verbose(f"variants search: seq window {wi + 1}/{len(wins)}")
        cbuf = _win_cbuf(codes, lo, hi, k)
        keys, isfw, valid = extract(jnp.asarray(cbuf), k)
        found, cv, fu, bu = partials[wi]
        partials[wi] = None  # free as we go
        out = scan(keys, isfw, jnp.asarray(found) & valid,
                   jnp.asarray(cv), jnp.asarray(fu), jnp.asarray(bu),
                   jnp.uint32(cutoff))
        _search_from_scan(dbg, codes, lo, hi, wa, wb, kcount, k,
                          max_span, cutoff, cache, variants, out)
        if log.verbose_flag:
            log.verbose(f"variants search: seq window "
                        f"{wi + 1}/{len(wins)} done "
                        f"({len(variants)} positions with variants)")


def _scan_window_variants(dbg, seg, codes, lo: int, hi: int, wa: int,
                          wb: int, kcount: int, k: int, max_span: int,
                          cutoff: int, table, cache, variants) -> None:
    """One fixed window [wa, wb) of the variants scan, probing buffer
    positions [lo, hi) (core + halos).

    ONE fused device program: extraction + sentinels + batched probe
    + depth-0 candidate scan (the quirk semantics of search_variants'
    first iteration: direction = isFw; fw side ignores the cutoff, bw
    side applies it; the reference-edge neighbour is excluded).
    Positions with no candidates are exactly those whose search
    extracts the source, explores nothing, and stops explored=True
    with no paths.  codes padded to a power-of-two bucket:
    compile-stable shapes (trailing BAD windows are invalid, so they
    probe as not-found and their sentinels collide with nothing)."""
    import numpy as np

    import jax.numpy as jnp

    global _scan_probe
    if _scan_probe is None:
        _scan_probe = _scan_probe_fn()
    nbase = hi - lo + k - 1  # codes feeding positions [lo, hi)
    pad = max(64, 1 << int(np.ceil(np.log2(nbase))))
    cbuf = np.full(pad, 4, np.uint8)
    cbuf[:nbase] = codes[lo:lo + nbase]
    if table.window_ranges() is not None:
        all_keys_d, isfw_d, search_d, covs, fws, bws = \
            _scan_probe_windowed(table, jnp.asarray(cbuf),
                                 jnp.uint32(cutoff), k)
    else:
        tkeys, tcov, tfw, tbw = table.device_arrays()
        use_merge = tkeys.shape[0] <= 6 * (pad - k + 1)
        if use_merge:
            bits, rounds = 8, 1
            starts = jnp.zeros((1 << bits) + 1, jnp.int32)
        else:
            starts, bits, rounds = table.bucket_index()
        all_keys_d, isfw_d, search_d, covs, fws, bws = _scan_probe(
            tkeys, tcov, tfw, tbw, starts, jnp.asarray(cbuf),
            jnp.uint32(cutoff), k, use_merge, bits, rounds)
    _search_from_scan(dbg, codes, lo, hi, wa, wb, kcount, k, max_span,
                      cutoff, cache, variants,
                      (all_keys_d, isfw_d, search_d, covs, fws, bws))


def _search_from_scan(dbg, codes, lo: int, hi: int, wa: int, wb: int,
                      kcount: int, k: int, max_span: int, cutoff: int,
                      cache, variants, scan_out) -> None:
    """Host tail of one variants window: reconstruct the reference's
    sliding targets state and run the exact Fibonacci-heap search on
    the branch points the device scan selected.  scan_out =
    (all_keys_d, isfw_d, search_d, covs, fws, bws) from either probe
    path (in-core fused or inverted out-of-core)."""
    import numpy as np

    all_keys_d, isfw_d, search_d, covs, fws, bws = scan_out
    all_keys = np.asarray(all_keys_d)  # host: targets windows need all
    all_isfw = np.asarray(isfw_d)
    nloc = hi - lo                     # real (non-pad) buffer positions
    keys_c = all_keys[:nloc]           # buffer-relative; abs = rel + lo

    # Only positions that are found AND have a non-reference candidate
    # run the host search.  The reference's targets_queue/targets_map
    # sliding state is reconstructed statelessly per search position
    # (byte-exact, incl. the quirk that popping the front erases a key
    # from the map even when a duplicate occurrence is still queued):
    # a key is in the map iff its latest append event is not older than
    # its latest pop event.  `ok` is always 1 (check_next never fails,
    # so edge_count == explored_count every iteration), so one pass
    # visits everything — no re-scan loop is needed.
    search_rel = np.nonzero(np.asarray(search_d)[:nloc])[0]
    search_rel = search_rel[(search_rel >= wa - lo)
                            & (search_rel < wb - lo)]  # core only
    if search_rel.size > 256:
        # many branch points: one bulk transfer beats per-row fetches
        covs, fws, bws = (np.asarray(a) for a in (covs, fws, bws))

    # last-occurrence index (ABSOLUTE positions), restricted to keys
    # that can actually be queried (those inside some search position's
    # target window): one sorted-membership pass over the buffer beats
    # a full stable argsort of all P keys
    occ_of: Dict[int, np.ndarray] = {}
    if search_rel.size:
        offs = np.arange(1, max_span + 1)
        wpos = (search_rel[:, None] + k + offs[None, :]).ravel()
        wpos = wpos[wpos < min(nloc, kcount - lo)]
        wvals = np.unique(keys_c[wpos])
        wi = np.minimum(np.searchsorted(wvals, keys_c), wvals.size - 1)
        occ_pos = np.nonzero(wvals[wi] == keys_c)[0]  # ascending
        occ_grp = np.argsort(wi[occ_pos], kind="stable")
        bounds = np.searchsorted(wi[occ_pos][occ_grp],
                                 np.arange(wvals.size + 1))
        for j, key in enumerate(wvals):
            occ_of[int(key)] = \
                occ_pos[occ_grp[bounds[j]:bounds[j + 1]]] + lo

    def last_occurrence_le(key, limit: int):
        """Largest abs position p <= limit with key at p, or None
        (positions before the buffer are invisible — see the halo
        argument in dbg_to_variants)."""
        occ = occ_of.get(int(key))
        if occ is None or occ.size == 0:
            return None
        j = int(np.searchsorted(occ, limit, side="right")) - 1
        return int(occ[j]) if j >= 0 else None

    def targets_state(c: int):
        """Queue + map exactly as after iteration c's maintenance."""
        w_lo, w_hi = c + k + 1, min(c + k + max_span + 1, kcount)
        queue = [int(all_keys[p - lo]) for p in range(w_lo, w_hi)]
        tmap: Dict[int, bool] = {}
        for p in range(w_lo, w_hi):
            key = int(all_keys[p - lo])
            if key in tmap:
                continue
            a = last_occurrence_le(np.uint64(key), w_hi - 1)  # == some p
            o = last_occurrence_le(np.uint64(key), c + k)
            a_time = max(a - k - max_span, -1)
            if o is None or a_time >= o - k:
                tmap[key] = True
        return queue, tmap

    for c_rel in search_rel:
        c = int(c_rel) + lo
        skey = int(all_keys[c_rel])
        is_fw = bool(all_isfw[c_rel])
        rec = (np.asarray(fws[c_rel]), np.asarray(bws[c_rel]),
               int(covs[c_rel]))
        ref_key = int(all_keys[c_rel + 1]) if c + 1 <= kcount - 1 \
            else None
        targets_queue, targets_map = targets_state(c)
        ok, paths = search_variants(
            dbg, skey, rec, is_fw, ref_key, targets_queue,
            targets_map, cache)
        assert ok, "searchVariants cannot end unexplored (see docstring)"
        for p in paths:
            p.pos = c + k
        if paths:
            variants.append(paths)


def search_variants(dbg, source_key: int, source_rec, is_source_fw: bool,
                    ref: Optional[int], targets_queue: List[int],
                    targets_map: Dict[int, bool],
                    cache: Dict[int, object]) -> Tuple[bool, List[DBGpath]]:
    """Reference: src/variants.cpp:171-310."""
    k = dbg.k
    table = dbg.table
    cutoff = dbg.ui.cov_cutoff
    kmer_depth = dbg.ui.resolved_kmer_depth()

    heap = FibonacciHeap()
    dist: Dict[int, int] = {source_key: 1}
    prev: Dict[int, Tuple[int, bool]] = {}
    vals: Dict[int, object] = {source_key: source_rec}
    destinations: List[int] = []
    discovered: List[DBGpath] = []
    heap.insert(source_key, 1)
    depth = 0
    direction = True
    explored = False

    def check_next(key: int, dirn: bool, ukey: int) -> bool:
        if key in targets_map:
            return True
        nxt = cache.get(key)
        if nxt is None:
            nxt = table.lookup(key)
            if nxt is None:
                return True  # edge recorded but neighbour absent
            cache[key] = nxt
        alt = dist[ukey]
        if alt < 255:
            alt += 1
        if key not in dist:
            dist[key] = 255
            vals[key] = nxt
            heap.insert(key, 0)
        if alt < dist[key]:
            prev[key] = (ukey, dirn)
            dist[key] = alt
            heap.decrease_key(key, alt)
        return True

    while heap.size() > 0 and depth < kmer_depth + 1:
        explored = False
        ukey = heap.extract_min()
        ufw, ubw, _ucov = vals[ukey]
        if ukey in prev:
            direction = prev[ukey][1]
        edge_count = 0
        explored_count = 0
        candidates: List[Tuple[int, bool, bool]] = []
        for i in range(4):
            if depth == 0:
                direction = bool(is_source_fw)
            # quirk: `direction ? fw[i] : bw[i] > covCutOff` applies
            # the cutoff only to the bw side (src/variants.cpp:236)
            cond = bool(ufw[i]) if direction else (ubw[i] > cutoff)
            if cond:
                raw = (next_key_fw(ukey, i, k) if direction
                       else next_key_bw(ukey, i, k))
                key, isfw = canonical(raw, k)
                if key != ref:
                    candidates.append((key, isfw, direction))
                    edge_count += 1
        for key, isfw, dirn in candidates:
            found = check_next(key, dirn if isfw else not dirn, ukey)
            if found:
                explored_count += 1
                if key in targets_map:
                    prev[key] = (ukey, dirn)
                    destinations.append(key)
        depth += 1
        if (edge_count == explored_count or depth == kmer_depth + 1
                or len(destinations) >= 10):
            explored = True

    def prev_get(key: int) -> Tuple[int, bool]:
        return prev.get(key, (0, False))

    for destination in destinations:
        path = DBGpath()
        try:
            ref_len = targets_queue.index(destination) + k
        except ValueError:
            ref_len = len(targets_queue) + k
        i = 0
        node = prev_get(destination)[0]
        while node != source_key:
            node = prev_get(node)[0]
            i += 1
        node = prev_get(destination)[0]
        direction = prev_get(node)[1]
        b = i - ref_len
        if ref_len > k:
            path.type = COM
            path.ref_len = ref_len - k + 1
            b = ref_len - k
        elif i == ref_len:
            path.type = SNV
        elif i > ref_len:
            path.type = DEL
            b -= 1
            node = prev_get(node)[0]
            direction = prev_get(node)[1]
        else:
            path.type = INS
        seq = []
        while b >= 0:
            seq.append(key_to_seq(node, k)[0] if direction
                       else revcom(key_to_seq(node, k)[k - 1]))
            node = prev_get(node)[0]
            direction = prev_get(node)[1]
            b -= 1
        path.sequence = "".join(reversed(seq))
        discovered.append(path)

    if explored:
        for key in dist:
            cache.pop(key, None)
    return explored, discovered
