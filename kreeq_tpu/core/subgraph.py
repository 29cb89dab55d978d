"""Subgraph extraction, graph search, unitig collapse, GFA emission.

Re-expression of the reference's subgraph mode (reference:
src/subgraph.cpp, src/kreeq.cpp:360-600):

  * extraction probes every assembly k-mer against the table in one
    batched device pass (replacing per-segment jobs + map-window
    paging, reference: src/subgraph.cpp:116-161),
  * graph searches (traversal = BFS rounds; best-first = bounded
    per-node Dijkstra with a shared memo cache) run on the host over
    the tiny subgraph, with DB lookups against the device-built table,
  * the unitig collapse walks unbranching runs exactly like the
    reference's collapseNodes so segment/edge counts match goldens.
"""

from __future__ import annotations

import sys

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.sequence import Edge, Genome
from .fibheap import FibonacciHeap
from .keys import (canonical, key_to_seq, mask, next_key_bw, next_key_fw,
                   revcomp_key)


class SubNode:
    """DBGkmer32color equivalent (reference: include/kreeq.h:126-136).

    A plain __slots__ class, not a dataclass: traversal creates one
    object per discovered node (~1M/Mbp), where dataclass __init__
    overhead was the measured bottleneck."""

    __slots__ = ("fw", "bw", "cov", "color")

    def __init__(self, fw=None, bw=None, cov=0, color=0):
        self.fw = [0, 0, 0, 0] if fw is None else fw
        self.bw = [0, 0, 0, 0] if bw is None else bw
        self.cov = cov
        # 0 gray (search-found), 1 blue (DB), 2 red (asm-only)
        self.color = color

    def fw_count(self) -> int:
        return sum(1 for v in self.fw if v)

    def bw_count(self) -> int:
        return sum(1 for v in self.bw if v)


LARGEST = 0xFFFFFFFF

_SUBNODE_EXT = None
_SUBNODE_EXT_TRIED = False


def _bulk_nodes(dst: dict, keys, fw, bw, cov, color: int = 0) -> None:
    """dst.update({keys[i]: SubNode(fw[i], bw[i], cov[i], color)}) in
    index order, via the C extension when available
    (native/subnode_ext.c: ~2.4x the Python object loop and no
    .tolist() passes — the traversal's measured host bottleneck).
    Duplicate keys keep their first-seen dict position (CPython update
    semantics), and values for duplicates are identical by
    construction (same table row), so this matches setdefault-based
    insertion exactly."""
    global _SUBNODE_EXT, _SUBNODE_EXT_TRIED
    if not _SUBNODE_EXT_TRIED:
        _SUBNODE_EXT_TRIED = True
        from ..native.subnode import get_module

        _SUBNODE_EXT = get_module()
    n = len(keys)
    if n == 0:
        return
    if _SUBNODE_EXT is not None:
        keys = np.ascontiguousarray(keys, np.uint64)
        fw = np.ascontiguousarray(fw, np.uint32)
        bw = np.ascontiguousarray(bw, np.uint32)
        cov = np.ascontiguousarray(cov, np.uint32)
        _SUBNODE_EXT.build_nodes(dst, n, keys.ctypes.data,
                                 fw.ctypes.data, bw.ctypes.data,
                                 cov.ctypes.data, color)
        return
    dst.update(zip(
        keys.tolist(),
        (SubNode(f, b, c, color) for f, b, c in
         zip(fw.tolist(), bw.tolist(), cov.tolist()))))


def _satadd(a: int, b: int) -> int:
    s = a + b
    return s if s <= LARGEST else LARGEST


def color_palette(value: int) -> str:
    """Reference: src/kreeq.cpp:337-349."""
    return {0: "gray", 1: "blue", 2: "red"}[value]


# -- extraction -------------------------------------------------------------


def extract_subgraph(dbg) -> Dict[int, SubNode]:
    """Collect DB nodes touched by the assembly (color 1) plus
    reconstructed assembly-only nodes (color 2) unless --no-reference
    (reference: src/subgraph.cpp:190-288), merged across segments with
    saturating adds (reference unionSum, src/subgraph.cpp:42-112)."""
    import jax.numpy as jnp

    from ..ops.kmers import kmer_positions
    from .dbg import _bucket

    ui = dbg.ui
    k = dbg.k
    table = dbg.table
    bed = _load_bed_spans(dbg) if ui.in_bed_include else None

    merged: Dict[int, SubNode] = {}
    for seg in dbg.genome.segments:
        ln = len(seg)
        if ln < k:
            continue
        kcount = ln - k + 1
        buf = np.full(_bucket(ln), 4, np.uint8)
        buf[:ln] = seg.codes
        keys, isfw, edges, valid = kmer_positions(jnp.asarray(buf), k)
        keys = np.asarray(keys[:kcount])
        isfw = np.asarray(isfw[:kcount])
        edges = np.asarray(edges[:kcount])
        valid = np.asarray(valid[:kcount])
        found, cov, fw, bw = table.probe(keys)

        spans = [(0, kcount)]
        if bed is not None:
            spans = bed.get(seg.header, [])

        # positions in span scan order; first occurrence of a key wins
        # (phmap insert semantics), vectorized via np.unique
        pos_parts = [np.arange(lo, min(hi, kcount)) for lo, hi in spans]
        pos = (np.concatenate(pos_parts) if pos_parts
               else np.empty(0, np.int64))
        pos = pos[valid[pos]]
        _u, first = np.unique(keys[pos], return_index=True)
        pos = pos[np.sort(first)]

        seg_map: Dict[int, SubNode] = {}
        # bulk .tolist(): one C-level pass instead of per-field int()
        for key, isf, fwr, bwr, c, e in zip(
                keys[pos].tolist(), found[pos].tolist(),
                fw[pos].tolist(), bw[pos].tolist(),
                cov[pos].tolist(), edges[pos].tolist()):
            if isf:
                seg_map[key] = SubNode(fwr, bwr, c, 1)
            elif not ui.no_reference:
                seg_map[key] = SubNode(
                    [(e >> w) & 1 for w in range(4)],
                    [(e >> (4 + w)) & 1 for w in range(4)], 1, 2)
        for key, node in seg_map.items():
            tgt = merged.get(key)
            if tgt is None:
                merged[key] = node
            else:
                for w in range(4):
                    tgt.fw[w] = _satadd(tgt.fw[w], node.fw[w])
                    tgt.bw[w] = _satadd(tgt.bw[w], node.bw[w])
                tgt.cov = _satadd(tgt.cov, node.cov)
    return merged


def _load_bed_spans(dbg):
    spans: Dict[str, List[Tuple[int, int]]] = {}
    with open(dbg.ui.in_bed_include) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                spans.setdefault(parts[0], []).append(
                    (int(parts[1]), int(parts[2])))
    # reference projects path coordinates onto segments
    # (src/kreeq.cpp:284-333); our segment headers are `<path>.<n>`.
    # NOTE: the reference never advances absPos across SEGMENT
    # components (only gaps) — an apparent bug we do not reproduce;
    # spans here use true absolute path coordinates (KNOWN_GAPS.md)
    out: Dict[str, List[Tuple[int, int]]] = {}
    for path in dbg.genome.paths:
        if path.header not in spans:
            continue
        abs_pos = 0
        for comp, obj in dbg.genome.path_components(path):
            if comp.ctype == "S":
                for b, e in spans[path.header]:
                    if abs_pos < b < abs_pos + len(obj):
                        out.setdefault(obj.header, []).append(
                            (b - abs_pos, e - abs_pos))
                abs_pos += len(obj)
            else:
                abs_pos += obj.dist
    return out


# -- DB neighbour lookup ----------------------------------------------------


def _db_node(table, key: int) -> Optional[SubNode]:
    rec = table.lookup(key)
    if rec is None:
        return None
    fw, bw, cov = rec
    return SubNode(list(map(int, fw)), list(map(int, bw)), cov, 0)


# -- searches ---------------------------------------------------------------


def traversal(dbg, sub: Dict[int, SubNode]) -> None:
    """BFS frontier expansion, kmerDepth rounds (reference:
    src/subgraph.cpp:301-415).

    Batched redesign: each round computes every frontier node's eight
    canonical neighbour keys vectorized (numpy), dedups to the first
    occurrence in the reference's exact scan order (frontier insertion
    order x fw0,bw0,..,fw3,bw3), and answers all lookups with ONE
    batched device probe.  Insertion order of discovered nodes — which
    goldens pin via GFA segment ids — is byte-identical to the scalar
    loop: keys absent from the DB never enter `new`, so ordering found
    candidates by first scan occurrence matches per-key lookups.
    """
    from ..ops.frontier import survivors_np, use_device
    from .keys import isin_sorted_np, neighbors8_np

    k = dbg.k
    table = dbg.table
    depth = dbg.ui.resolved_kmer_depth()
    candidates: Dict[int, SubNode] = {}

    sub_sorted = np.sort(np.fromiter(sub.keys(), np.uint64, len(sub)))
    fkeys = np.fromiter(sub.keys(), np.uint64, len(sub))
    ffw = np.array([n.fw for n in sub.values()],
                   np.uint32).reshape(-1, 4)
    fbw = np.array([n.bw for n in sub.values()],
                   np.uint32).reshape(-1, 4)

    if use_device(fkeys.size):
        _traversal_device(dbg, sub, candidates, sub_sorted,
                          fkeys, ffw, fbw, depth)
    else:
        for _ in range(depth):
            if fkeys.size == 0:
                break
            cand = neighbors8_np(fkeys, k)  # [n, 8] scan order
            emask = np.empty((fkeys.size, 8), bool)
            emask[:, 0::2] = ffw != 0
            emask[:, 1::2] = fbw != 0
            ok = emask & ~isin_sorted_np(sub_sorted, cand)
            flat_idx = np.nonzero(ok.ravel())[0]
            vals = cand.ravel()[flat_idx]
            _u, first = np.unique(vals, return_index=True)
            ckeys = vals[np.sort(first)]  # ordered unique candidates
            if ckeys.size == 0:
                break
            pad = max(64, 1 << int(np.ceil(np.log2(ckeys.size))))
            qbuf = np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)
            qbuf[:ckeys.size] = ckeys
            found, cov, fw, bw = table.probe(qbuf)
            hit = np.nonzero(found[:ckeys.size])[0]
            fkeys = ckeys[hit]
            ffw = fw[hit]
            fbw = bw[hit]
            _bulk_nodes(candidates, fkeys, ffw, fbw, cov[hit])
    for key, node in candidates.items():
        sub.setdefault(key, node)


def _traversal_device(dbg, sub, candidates, sub_sorted, fkeys, ffw,
                      fbw, depth: int) -> None:
    """Device-resident BFS rounds: the frontier (keys + edge counters)
    never round-trips to the host between rounds (no per-round
    re-upload of ~40 B/node).  Per round only the (typically small)
    candidate set is read back for the insertion-ordered bookkeeping
    the goldens pin.  Byte-identical to the host loop."""
    import jax.numpy as jnp

    from ..ops.frontier import survivors_dev

    k = dbg.k
    table = dbg.table
    spad = max(64, 1 << int(np.ceil(np.log2(max(sub_sorted.size, 1)))))
    sbuf = np.full(spad, 0xFFFFFFFFFFFFFFFF, np.uint64)
    sbuf[:sub_sorted.size] = sub_sorted
    sub_d = jnp.asarray(sbuf)

    def pad_up(a, fill):
        n = a.shape[0]
        npad = max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
        if npad == n:
            return jnp.asarray(a)
        pad = np.full((npad - n,) + a.shape[1:], fill, a.dtype)
        return jnp.asarray(np.concatenate([a, pad]))

    fkeys_d = pad_up(fkeys, 0xFFFFFFFFFFFFFFFF)
    ffw_d = pad_up(ffw, 0)
    fbw_d = pad_up(fbw, 0)

    # fused async rounds need the whole table device-resident
    fused = (table.window_ranges() is None and len(table) > 0)
    if fused and fkeys_d.shape[0] <= (1 << 20):
        _traversal_rounds_async(table, sub_d, fkeys_d, ffw_d, fbw_d,
                                depth, k, candidates)
        return

    for _ in range(depth):
        vals = survivors_dev(fkeys_d, ffw_d, fbw_d, sub_d, k, 0)
        if vals.size == 0:
            break
        _u, first = np.unique(vals, return_index=True)
        ckeys = vals[np.sort(first)]  # ordered unique candidates
        if ckeys.size == 0:
            break
        pad = max(64, 1 << int(np.ceil(np.log2(ckeys.size))))
        qbuf = np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)
        qbuf[:ckeys.size] = ckeys
        qbuf_d = jnp.asarray(qbuf)
        found_d, cov_d, fw_d, bw_d = table.probe_device(qbuf_d)
        # next frontier stays on device; dead slots carry SENTINEL
        # keys, which the survivor scan ignores
        fkeys_d = jnp.where(found_d, qbuf_d,
                            jnp.uint64(0xFFFFFFFFFFFFFFFF))
        ffw_d = jnp.where(found_d[:, None], fw_d, 0)
        fbw_d = jnp.where(found_d[:, None], bw_d, 0)
        found = np.asarray(found_d)[:ckeys.size]
        # host bookkeeping of the round's discoveries (insertion order)
        hit = np.nonzero(found)[0]
        if hit.size == 0:
            break
        hkeys = ckeys[hit]
        hfw = np.asarray(fw_d)[:ckeys.size][hit]
        hbw = np.asarray(bw_d)[:ckeys.size][hit]
        hcov = np.asarray(cov_d)[:ckeys.size][hit]
        _bulk_nodes(candidates, hkeys, hfw, hbw, hcov)


def _traversal_rounds_async(table, sub_d, fkeys_d, ffw_d, fbw_d,
                            depth: int, k: int, candidates) -> None:
    """Fused-batch BFS rounds: round 1 runs as its own program (the
    initial frontier's large shape), rounds 2+ run FUSED, R=4 rounds
    per device program via lax.scan (ops/frontier._expand_rounds_scan).
    Fusing divides the dispatch count by R while the per-batch drain
    checks convergence (dead frontier) and cap overflow.

    A cap overflow restarts the whole traversal with a doubled cap
    (rare: caps only grow); reprocessing completed rounds is
    idempotent — the candidates dict keeps first-insertion order and
    identical values, so results are byte-identical to the per-round
    path (scripts/bench_subgraph.py asserts sets AND order)."""
    from ..ops.frontier import _expand_round, _expand_rounds_scan

    tkeys, tcov, tfw, tbw = table.device_arrays()
    tstarts, bits, _rounds = table.bucket_index()
    R = 4
    cap = 1 << 14

    def process(p, cap_used):
        """Unpack one round's [cap+1, 6] matrix into candidates.
        Returns ('overflow'|'done'|'ok', survivor count)."""
        cnt = int(p[0, 0])
        if cnt > cap_used:
            return "overflow", cnt
        if cnt == 0:
            return "done", 0
        rows = p[1:cnt + 1]
        keys_r = rows[:, 0]
        cov_r = (rows[:, 1] & 0xFFFFFFFF).astype(np.uint32)
        found_r = (rows[:, 1] >> np.uint64(32)) != 0
        fwb = np.empty((cnt, 4), np.uint32)
        bwb = np.empty((cnt, 4), np.uint32)
        for w, col in ((0, 2), (2, 3)):
            fwb[:, w] = (rows[:, col] & 0xFFFFFFFF).astype(np.uint32)
            fwb[:, w + 1] = (rows[:, col] >> np.uint64(32)) \
                .astype(np.uint32)
        for w, col in ((0, 4), (2, 5)):
            bwb[:, w] = (rows[:, col] & 0xFFFFFFFF).astype(np.uint32)
            bwb[:, w + 1] = (rows[:, col] >> np.uint64(32)) \
                .astype(np.uint32)
        hit = np.nonzero(found_r)[0]
        if hit.size == 0:
            return "done", cnt
        _bulk_nodes(candidates, keys_r[hit], fwb[hit], bwb[hit],
                    cov_r[hit])
        return "ok", cnt

    while True:  # overflow restart loop (cap only grows)
        cap1 = min(cap, fkeys_d.shape[0] * 8)
        packed1, nk, nf, nb = _expand_round(
            fkeys_d, ffw_d, fbw_d, sub_d, k, np.uint32(0), cap1, bits,
            tkeys=tkeys, tcov=tcov, tfw=tfw, tbw=tbw, tstarts=tstarts)
        status, cnt = process(np.asarray(packed1), cap1)
        if status == "overflow":
            cap = 1 << int(np.ceil(np.log2(cnt)))
            continue
        if status == "done" or depth <= 1:
            return
        st = (nk, nf, nb)
        r = 1
        restart = False
        while r < depth:
            packs, st = _expand_rounds_scan(
                st[0], st[1], st[2], sub_d, k, np.uint32(0), cap,
                bits, R, tkeys=tkeys, tcov=tcov, tfw=tfw, tbw=tbw,
                tstarts=tstarts)
            p = np.asarray(packs)
            for i in range(min(R, depth - r)):
                status, cnt = process(p[i], cap)
                if status == "overflow":
                    cap = 1 << int(np.ceil(np.log2(cnt)))
                    restart = True
                    break
                r += 1
                if status == "done":
                    return
            if restart:
                break
        if not restart:
            return


def best_first(dbg, sub: Dict[int, SubNode]) -> Dict[int, SubNode]:
    """Per-node bounded Dijkstra with shared cache (reference:
    src/subgraph.cpp:417-579).

    Batched prefilter: a source whose depth-0 iteration can insert no
    node — every above-cutoff neighbour is already in the subgraph or
    absent from the DB — runs to an empty heap with zero discoveries
    and zero cache writes (in-sub neighbours only append the source
    itself to `destinations`, whose backtrack loop is then a no-op),
    so skipping it is exact.  One vectorized neighbour scan plus one
    batched device probe selects the true boundary sources; only those
    run the host Fibonacci-heap search.
    """
    cache: Dict[int, SubNode] = {}
    candidates: Dict[int, SubNode] = {}
    copy: Dict[int, SubNode] = {}
    need = _boundary_sources(dbg, sub)
    for idx, (key, node) in enumerate(sub.items()):
        if need[idx]:
            _explored, discovered = _dijkstra(dbg, sub, key, node, cache)
            for dk, dn in discovered.items():
                candidates.setdefault(dk, dn)
        copy[key] = node
    for dk, dn in candidates.items():
        copy.setdefault(dk, dn)
    return copy


def _boundary_sources(dbg, sub: Dict[int, SubNode]):
    """Mask over sub's insertion order: sources whose depth-0 scan can
    insert at least one node (above-cutoff edge to a key that is not
    in sub and is in the DB)."""
    from ..ops.frontier import survivors_np, use_device
    from .keys import isin_sorted_np, neighbors8_np

    n = len(sub)
    if n == 0:
        return np.zeros(0, bool)
    k = dbg.k
    cutoff = dbg.ui.cov_cutoff
    keys = np.fromiter(sub.keys(), np.uint64, n)
    fw = np.array([nd.fw for nd in sub.values()], np.uint32) \
        .reshape(-1, 4)
    bw = np.array([nd.bw for nd in sub.values()], np.uint32) \
        .reshape(-1, 4)
    if use_device(n):
        flat, flat_idx = survivors_np(keys, fw, bw, np.sort(keys), k,
                                      cutoff)
        rows = flat_idx // 8
    else:
        cand = neighbors8_np(keys, k)  # fw0,bw0,..,fw3,bw3
        elig = np.empty((n, 8), bool)
        elig[:, 0::2] = fw > cutoff
        elig[:, 1::2] = bw > cutoff
        maybe = elig & ~isin_sorted_np(np.sort(keys), cand)
        flat = cand[maybe]
        rows = np.repeat(np.arange(n), maybe.sum(axis=1))
    if flat.size == 0:
        return np.zeros(n, bool)
    uniq = np.unique(flat)
    pad = max(64, 1 << int(np.ceil(np.log2(uniq.size))))
    qbuf = np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)
    qbuf[:uniq.size] = uniq
    found, _c, _f, _b = dbg.table.probe(qbuf)
    hit = found[:uniq.size][np.searchsorted(uniq, flat)]
    need = np.zeros(n, bool)
    need[rows[hit]] = True
    return need


def _dijkstra(dbg, sub, source_key: int, source_node: SubNode, cache):
    """Reference: src/subgraph.cpp:460-579.  depth counts extracted
    nodes, not levels; all queued nodes carry priority 0 (insert-then-
    refused-decreaseKey), so order follows the heap mechanics."""
    k = dbg.k
    table = dbg.table
    cutoff = dbg.ui.cov_cutoff
    kmer_depth = dbg.ui.resolved_kmer_depth()

    heap = FibonacciHeap()
    dist: Dict[int, int] = {source_key: 1}
    prev: Dict[int, Tuple[int, bool]] = {}
    vals: Dict[int, SubNode] = {source_key: source_node}
    discovered: Dict[int, SubNode] = {}
    destinations: List[int] = []
    heap.insert(source_key, 1)
    depth = 0
    direction = True
    explored = False

    def check_next(key: int, dirn: bool, ukey: int) -> bool:
        if key in sub:
            return True
        nxt = cache.get(key)
        if nxt is None:
            nxt = _db_node(table, key)
            if nxt is None:
                return True  # edge present but neighbour not in DB
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
        uval = vals[ukey]
        if ukey in prev:
            direction = prev[ukey][1]
        edge_count = 0
        explored_count = 0
        for i in range(4):
            if direction or depth == 0:
                if depth == 0:
                    direction = True
                if uval.fw[i] > cutoff:
                    nk, isfw = canonical(next_key_fw(ukey, i, k), k)
                    if check_next(nk, direction if isfw else not direction,
                                  ukey):
                        explored_count += 1
                        if nk in sub:
                            destinations.append(ukey)
                    edge_count += 1
            if (not direction) or depth == 0:
                if depth == 0:
                    direction = False
                if uval.bw[i] > cutoff:
                    nk, isfw = canonical(next_key_bw(ukey, i, k), k)
                    if check_next(nk, direction if isfw else not direction,
                                  ukey):
                        explored_count += 1
                        if nk in sub:
                            destinations.append(ukey)
                    edge_count += 1
        depth += 1
        if (edge_count == explored_count or depth == kmer_depth + 1
                or len(destinations) >= 10):
            explored = True

    for dest in destinations:
        while dest != source_key:
            node = cache.get(dest)
            if node is not None:
                discovered.setdefault(
                    dest, SubNode(list(node.fw), list(node.bw), node.cov, 0))
            dist.pop(dest, None)
            dest = prev[dest][0]
    if explored:
        for key in dist:
            cache.pop(key, None)
    return explored, discovered


def search_graph(dbg, sub: Dict[int, SubNode]) -> Dict[int, SubNode]:
    """Reference: src/subgraph.cpp:290-299."""
    alg = dbg.ui.trav_algorithm
    if alg == "best-first":
        return best_first(dbg, sub)
    if alg == "traversal":
        traversal(dbg, sub)
        return sub
    sys.stderr.write(
        f"Cannot find input algorithm ({alg}). Terminating.\n")
    sys.exit(1)


# -- pruning + summary ------------------------------------------------------


def remove_missing_edges(dbg, sub: Dict[int, SubNode]) -> None:
    """Zero edges whose endpoint is not in the subgraph; only counters
    above the cutoff are eligible for pruning (reference quirk,
    src/subgraph.cpp:599-628).  All 8n canonical neighbour keys and
    their membership tests run vectorized; only nodes that actually
    prune are touched in Python."""
    from ..ops.frontier import survivors_np, use_device
    from .keys import isin_sorted_np, neighbors8_np

    if not sub:
        return
    k = dbg.k
    cutoff = dbg.ui.cov_cutoff
    keys = np.fromiter(sub.keys(), np.uint64, len(sub))
    fw = np.array([n.fw for n in sub.values()], np.uint32).reshape(-1, 4)
    bw = np.array([n.bw for n in sub.values()], np.uint32).reshape(-1, 4)
    nodes = list(sub.values())
    if use_device(keys.size):
        _vals, flat_idx = survivors_np(keys, fw, bw, np.sort(keys), k,
                                       cutoff)
        for f in flat_idx:
            node = nodes[f // 8]
            slot = f % 8
            if slot % 2 == 0:
                node.fw[slot // 2] = 0
            else:
                node.bw[slot // 2] = 0
        return
    cand = neighbors8_np(keys, k)  # [n, 8] = fw0,bw0,..,fw3,bw3
    eligible = np.empty((keys.size, 8), bool)
    eligible[:, 0::2] = fw > cutoff
    eligible[:, 1::2] = bw > cutoff
    prune = eligible & ~isin_sorted_np(np.sort(keys), cand)
    for r in np.nonzero(prune.any(axis=1))[0]:
        node = nodes[r]
        for i in range(4):
            if prune[r, 2 * i]:
                node.fw[i] = 0
            if prune[r, 2 * i + 1]:
                node.bw[i] = 0


def subgraph_summary_lines(sub: Dict[int, SubNode], k: int) -> List[str]:
    """Reference: src/subgraph.cpp:163-188 (same either-side edge
    quirk as DBstats)."""
    tot = sum(n.cov for n in sub.values())
    unique = sum(1 for n in sub.values() if n.cov == 1)
    distinct = len(sub)
    edges = sum(1 for n in sub.values() for w in range(4)
                if n.fw[w] > 0 or n.bw[w] > 0)
    return [
        "Subgraph summary statistics:",
        f"Total kmers: {tot}",
        f"Unique kmers: {unique}",
        f"Distinct kmers: {distinct}",
        f"Missing kmers: {4 ** k - distinct}",
        f"Total edges: {edges}",
    ]


# -- GFA emission -----------------------------------------------------------


def graph_to_gfa(dbg, sub: Dict[int, SubNode]) -> Genome:
    """Reference: src/kreeq.cpp:523-600 (DBGgraphToGFA)."""
    if not dbg.ui.no_collapse:
        return collapse_nodes(dbg, sub)
    k = dbg.k
    gfa = Genome()
    id_counter = 0
    edge_counter = 0
    seg_of_key: Dict[int, object] = {}
    for key, node in sub.items():
        seg = gfa.add_segment(str(id_counter), key_to_seq(key, k),
                              seq_pos=id_counter,
                              tags=[("f", "DP", str(node.cov)),
                                    ("Z", "CB", color_palette(node.color))])
        seg_of_key[key] = seg
        id_counter += 1
    for key, node in sub.items():
        this_seg = seg_of_key[key]
        # two separate passes, like the reference (src/kreeq.cpp:549-593)
        for i in range(4):
            if node.fw[i] == 0:
                continue
            nk, isfw = canonical(next_key_fw(key, i, k), k)
            nxt = seg_of_key.get(nk)
            if nxt is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter, this_seg.uid,
                              nxt.uid, "+", "+" if isfw else "-",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.fw[i]))]))
            id_counter += 1
            edge_counter += 1
        for i in range(4):
            if node.bw[i] == 0:
                continue
            nk, isfw = canonical(next_key_bw(key, i, k), k)
            prv = seg_of_key.get(nk)
            if prv is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter, prv.uid,
                              this_seg.uid, "+" if isfw else "-", "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.bw[i]))]))
            id_counter += 1
            edge_counter += 1
    return gfa


RESIDUAL_DICT = dict  # test hook: swap for a tracing dict


def collapse_nodes(dbg, sub: Dict[int, SubNode]) -> Genome:
    """Greedy unbranching-run collapse into unitigs (reference:
    src/kreeq.cpp:360-521).  Output counts are traversal-order
    independent; node choice follows dict order (the reference picks
    arbitrary phmap order)."""
    k = dbg.k
    gfa = Genome()
    id_counter = 0
    edge_counter = 0
    # residual: key -> (node snapshot, unitig id, direction)
    residual: Dict[int, Tuple[SubNode, int, int]] = RESIDUAL_DICT()

    def extend(seed: List[int], direction: int) -> List[int]:
        """seed: list of base codes (length >= k), extended in place.
        Returns the grown seed (reference collapseNodes extend lambda,
        src/kreeq.cpp:365-427)."""
        nonlocal residual
        fwkey = 0
        for i, b in enumerate(seed[:k]):
            fwkey |= b << (2 * i)
        rckey = revcomp_key(fwkey, k)
        key, isfw = (fwkey, True) if fwkey <= rckey else (rckey, False)
        node = sub.get(key)
        if node is None:
            return seed
        top = 2 * (k - 1)
        kmask = mask(k)
        while True:
            idx = ([i for i in range(4) if node.fw[i]] if isfw
                   else [3 - i for i in range(4) if node.bw[i]])
            i = idx[0]
            # next kmer = window shifted one base fw: both packings
            # update in O(1) (the rc of a fw-shift prepends the
            # complement base), replacing the per-step O(k) repack +
            # revcomp of the scalar canonical()
            fwkey = (fwkey >> 2) | (i << top)
            rckey = ((rckey << 2) & kmask) | (3 - i)
            key_prev, node_prev = key, node
            key, isfw = ((fwkey, True) if fwkey <= rckey
                         else (rckey, False))
            got = sub.get(key)
            if got is None:
                if key in residual:
                    residual[key_prev] = (node_prev, id_counter, direction)
                break
            node = got
            front = ([w for w in range(4) if node.fw[w]] if isfw
                     else [w for w in range(4) if node.bw[w]])
            back = ([w for w in range(4) if node.bw[w]] if isfw
                    else [w for w in range(4) if node.fw[w]])
            if len(back) > 1:
                residual[key_prev] = (node_prev, id_counter, direction)
                break
            seed.append(i)
            del sub[key]
            if len(front) == 0:
                break
            if len(front) > 1:
                residual[key] = (node, id_counter, direction)
                break
        return seed

    while sub:
        key = next(iter(sub))
        node = sub[key]
        front = [(key >> (2 * i)) & 3 for i in range(k)]
        back = [3 - b for b in reversed(front)]
        edge_counts = (node.bw_count(), node.fw_count())
        snapshot = SubNode(list(node.fw), list(node.bw), node.cov,
                           node.color)
        if edge_counts[0] == 1 or edge_counts[1] == 1:
            for direction in (1, 0):
                if edge_counts[direction] == 1:
                    if direction:
                        front = extend(front, 1)
                    else:
                        back = extend(back, 0)
                elif edge_counts[direction] > 1:
                    residual[key] = (snapshot, id_counter, direction)
            sub.pop(key, None)
        else:
            residual[key] = (snapshot, id_counter, 0)
            sub.pop(key, None)  # reference never erases here (would hang)
        # unitig = revcom(back) + front[k:]
        seq_codes = [3 - b for b in reversed(back)] + front[k:]
        from ..constants import ITOC

        seq = "".join(ITOC[b] for b in seq_codes)
        gfa.add_segment(str(id_counter), seq, seq_pos=id_counter,
                        tags=[("f", "DP", str(snapshot.cov)),
                              ("Z", "CB", color_palette(snapshot.color))])
        id_counter += 1

    seg_by_header = {s.header: s for s in gfa.segments}
    # the reference consumes residualEdges head-first; a neighbour's
    # reciprocal edge is skipped once the head is erased, so each
    # unitig adjacency is emitted exactly once
    # (reference: src/kreeq.cpp:463-519)
    while residual:
        key = next(iter(residual))
        node, uid, direction = residual[key]
        this_header = str(uid)
        # two separate passes, like the reference (src/kreeq.cpp:468-517)
        for i in range(4):
            if node.fw[i] == 0:
                continue
            nk, _ = canonical(next_key_fw(key, i, k), k)
            got = residual.get(nk)
            if got is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter,
                              seg_by_header[this_header].uid,
                              seg_by_header[str(got[1])].uid,
                              "+" if direction else "-",
                              "-" if got[2] else "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.fw[i]))]))
            id_counter += 1
            edge_counter += 1
        for i in range(4):
            if node.bw[i] == 0:
                continue
            nk, _ = canonical(next_key_bw(key, i, k), k)
            got = residual.get(nk)
            if got is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter,
                              seg_by_header[str(got[1])].uid,
                              seg_by_header[this_header].uid,
                              "+" if got[2] else "-",
                              "-" if direction else "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.bw[i]))]))
            id_counter += 1
            edge_counter += 1
        del residual[key]
    return gfa


# -- driver -----------------------------------------------------------------


def run_subgraph(dbg, out=None) -> None:
    """Reference flow: src/input.cpp:153-180."""
    out = out or sys.stdout
    if not dbg.ui.in_sequence:
        return
    sub = extract_subgraph(dbg)
    sub = search_graph(dbg, sub)
    remove_missing_edges(dbg, sub)
    out.write("\n".join(subgraph_summary_lines(sub, dbg.k)) + "\n")
    dbg.subgraph_nodes = dict(sub)
    gfa = graph_to_gfa(dbg, sub)
    dbg.subgraph_gfa = gfa
    from .gfastats import report_stats_lines

    out.write("\n".join(report_stats_lines(gfa)) + "\n")
