"""DBG workload driver: build/load tables, QV validation, reporting.

Orchestration equivalent of the reference's DBG class methods
validateSequences/DBstats/report (reference: src/kreeq.cpp:47-108,
src/graph-builder.cpp:284-295, src/kreeq-output.cpp:34-136), with the
out-of-core map-window paging loops collapsed away: the whole table is
device-resident, so every "for each RAM-fitting window of partitions"
rescan (reference: src/kreeq.cpp:59-76) becomes a single batched pass.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import UserInput
from ..io.sequence import Genome
from ..utils.fmt import cpp_double
from .table import KmerTable


def error_rate(missing: int, total: int, k: int) -> float:
    """Reference: src/kreeq.cpp:36-40."""
    if total == 0:
        return float("nan")
    return 1 - (1 - missing / total) ** (1 / k)


def _bucket(n: int) -> int:
    """Pad to a power-of-two bucket to bound JIT recompilation."""
    return 1 << max(6, int(math.ceil(math.log2(max(n, 1) + 1))))


@dataclass
class SegmentTrack:
    """Per-base validation track of one segment (DBGbase equivalent,
    reference: include/input.h:4-9)."""

    cov: np.ndarray  # u32 [len]
    isfw: np.ndarray  # bool [len]
    right: np.ndarray  # u32 [len]  (edge toward higher coordinates)
    left: np.ndarray  # u32 [len]


class DBG:
    """The k-mer DB plus workloads against a loaded genome."""

    def __init__(self, user_input: UserInput, table: KmerTable) -> None:
        self.ui = user_input
        self.table = table
        self.genome: Optional[Genome] = None
        self.tracks: List[Optional[SegmentTrack]] = []
        self.tot_missing = 0
        self.tot_kcount = 0
        self.tot_edge_missing = 0

    @property
    def k(self) -> int:
        return self.table.k

    # -- summary -----------------------------------------------------------

    def db_stats_lines(self) -> List[str]:
        """Reference: src/graph-builder.cpp:284-295 (DBstats)."""
        st = self.table.stats()
        return [
            "DBG Summary statistics:",
            f"Total kmers: {st.total}",
            f"Unique kmers: {st.unique}",
            f"Distinct kmers: {st.distinct}",
            f"Missing kmers: {st.missing(self.k)}",
            f"Total edges: {st.edges}",
        ]

    def print_db_stats(self, out=None) -> None:
        out = out or sys.stdout
        out.write("\n".join(self.db_stats_lines()) + "\n")

    # -- validation (QV) ---------------------------------------------------

    def load_genome(self, genome: Genome) -> None:
        self.genome = genome

    # window width for chromosome-scale segments: positions are
    # processed in fixed windows with one base of edge context on each
    # side, bounding device memory and JIT shapes
    VALIDATE_WINDOW = 1 << 22

    def validate_sequences(self, out=None, need_tracks: bool = True) -> None:
        """QV computation + per-base tracks (reference:
        src/kreeq.cpp:47-108).

        need_tracks=False is the sums-only fast path for plain
        `validate`: the reference always fills DBGbase tracks, but
        they feed only the QV totals unless a bed/csv/kwig/bkwig
        writer runs (src/kreeq-output.cpp:62-83) — skipping them drops
        the per-window track readbacks.  Output (the QV table) is
        identical."""
        out = out or sys.stdout
        if not self.ui.in_sequence:
            return
        import jax.numpy as jnp

        from ..ops.validate import qv_window_sums, validate_positions

        # out-of-core paging: when the table exceeds the device row cap
        # the probe loops HBM-resident key-range windows (reference
        # analog: map-range rescans, src/kreeq.cpp:59-76)
        windowed = self.table.window_ranges() is not None

        k = self.k
        self.tracks = []
        self.tot_missing = 0
        self.tot_kcount = 0
        self.tot_edge_missing = 0
        if windowed:
            tkeys = tcov = tfw = tbw = None
        elif len(self.table):
            tkeys, tcov, tfw, tbw = self.table.device_arrays()
        else:
            tkeys = jnp.zeros(1, jnp.uint64) - 1
            tcov = jnp.zeros(1, jnp.uint32)
            tfw = jnp.zeros((1, 4), jnp.uint32)
            tbw = jnp.zeros((1, 4), jnp.uint32)
        # the merge-vs-bisection choice is per WINDOW (same rule as
        # KmerTable.probe: merge only when the table isn't much larger
        # than this window's batch) — a fragmented assembly probes many
        # small windows, and sorting the whole table per tiny window
        # would dwarf the bucketed gathers.  The bucket index is cached
        # on the table, fetched only if some window takes bisection.
        empty_starts = jnp.zeros((1 << 8) + 1, jnp.int32)

        def probe_params(nbuf: int):
            if not len(self.table):
                return False, empty_starts, 8, 1
            if tkeys.shape[0] <= 6 * nbuf:
                return True, empty_starts, 8, 1
            starts, bits, rounds = self.table.bucket_index()
            return False, starts, bits, rounds
        if windowed:
            self._validate_windowed(need_tracks)
        for seg in (() if windowed else self.genome.segments):
            ln = len(seg)
            if ln < k:
                if need_tracks:
                    self.tracks.append(
                        SegmentTrack(np.zeros(ln, np.uint32),
                                     np.zeros(ln, bool),
                                     np.zeros(ln, np.uint32),
                                     np.zeros(ln, np.uint32)))
                continue
            codes = seg.codes
            kcount = ln - k + 1
            track = SegmentTrack(np.zeros(ln, np.uint32),
                                 np.zeros(ln, bool),
                                 np.zeros(ln, np.uint32),
                                 np.zeros(ln, np.uint32)) \
                if need_tracks else None
            pending = []  # device QV sums; read back after dispatch
            for a, b, lead, buf in self._seq_windows(codes, kcount):
                use_merge, starts, bits, rounds = probe_params(
                    buf.shape[0])
                (valid, missing, edge_missing, cov, isfw, right,
                 left) = validate_positions(tkeys, tcov, tfw, tbw, starts,
                                            jnp.asarray(buf), k,
                                            self.ui.cov_cutoff, bits,
                                            rounds, use_merge)
                if not need_tracks:
                    pending.append(qv_window_sums(
                        missing, edge_missing, jnp.uint32(lead),
                        jnp.uint32(lead + (b - a))))
                    continue
                sl = slice(lead, lead + (b - a))
                self.tot_missing += int(np.asarray(missing[sl]).sum())
                self.tot_edge_missing += int(
                    np.asarray(edge_missing[sl]).sum())
                track.cov[a:b] = np.asarray(cov[sl])
                track.isfw[a:b] = np.asarray(isfw[sl])
                track.right[a:b] = np.asarray(right[sl])
                track.left[a:b] = np.asarray(left[sl])
            for res in pending:
                arr = np.asarray(res)
                self.tot_missing += int(arr[0])
                self.tot_edge_missing += int(arr[1])
            self.tot_kcount += kcount
            if need_tracks:
                self.tracks.append(track)

        self._print_qv(out, k)

    def _window_buf(self, codes, a: int, b: int, kcount: int):
        """One validate-window buffer: one base of context on each
        side keeps the edge tests exact at window seams."""
        win = self.VALIDATE_WINDOW
        k = self.k
        nbuf = _bucket(b - a + k + 1) if b - a + k + 1 < win \
            else win + k + 1
        buf = np.full(nbuf, 4, np.uint8)
        lead = 1
        if a > 0:
            buf[0] = codes[a - 1]
        buf[lead:lead + (b - a) + k - 1] = codes[a:b + k - 1]
        if b < kcount:
            buf[lead + (b - a) + k - 1] = codes[b + k - 1]
        return buf

    def _seq_windows(self, codes, kcount: int):
        """(a, b, lead, buf) per fixed validate window of one
        segment."""
        win = self.VALIDATE_WINDOW
        for a in range(0, kcount, win):
            b = min(a + win, kcount)
            yield a, b, 1, self._window_buf(codes, a, b, kcount)

    def _validate_windowed(self, need_tracks: bool = True) -> None:
        """Out-of-core validate with the loop order INVERTED: table
        key-range windows OUTER, sequence windows inner — each table
        window is uploaded exactly once per run, exactly like the
        reference's map-range rescans (reference: src/kreeq.cpp:59-76;
        the naive order would re-upload the whole table once per
        sequence window).  Per position, the context-selected probe
        result (found, cov, right, left — 13 B) accumulates on the
        host; at most one window finds any key, so combination is
        first-found-wins.  A final device pass per sequence window
        classifies from the accumulated selection."""
        import jax.numpy as jnp

        from ..ops.validate import _extract_ctx, select_by_ctx

        k = self.k
        ranges = self.table.window_ranges()
        segs = [(si, seg) for si, seg in enumerate(self.genome.segments)]
        # host accumulators per segment (13 B / position)
        accs = {}
        for si, seg in segs:
            kcount = len(seg) - k + 1
            if kcount > 0:
                accs[si] = (np.zeros(kcount, bool),
                            np.zeros(kcount, np.uint32),
                            np.zeros(kcount, np.uint32),
                            np.zeros(kcount, np.uint32))

        for w in range(len(ranges)):
            arrays = self.table.device_arrays(w)
            for si, seg in segs:
                if si not in accs:
                    continue
                codes = seg.codes
                kcount = len(seg) - k + 1
                af, ac, ar, al = accs[si]
                for a, b, lead, buf in self._seq_windows(codes, kcount):
                    keys, _isfw, _valid, ctx = _extract_ctx(
                        jnp.asarray(buf), k)
                    probe = self.table._probe_one(
                        arrays, keys, lambda w=w: self.table.bucket_index(w))
                    f, c, r, ll = select_by_ctx(*probe, ctx)
                    sl = slice(lead, lead + (b - a))
                    f = np.asarray(f[sl])
                    hit = np.nonzero(f)[0]
                    if hit.size == 0:
                        continue
                    ac[a:b][hit] = np.asarray(c[sl])[hit]
                    ar[a:b][hit] = np.asarray(r[sl])[hit]
                    al[a:b][hit] = np.asarray(ll[sl])[hit]
                    af[a:b][hit] = True

        # final pass: classification from the accumulated selection
        # (need_tracks=False — plain `validate` at out-of-core scale —
        # keeps the QV sums but skips materializing per-base tracks,
        # halving host memory per position)
        for si, seg in segs:
            ln = len(seg)
            if si not in accs:
                if need_tracks:
                    self.tracks.append(
                        SegmentTrack(np.zeros(ln, np.uint32),
                                     np.zeros(ln, bool),
                                     np.zeros(ln, np.uint32),
                                     np.zeros(ln, np.uint32)))
                continue
            codes = seg.codes
            kcount = ln - k + 1
            af, ac, ar, al = accs[si]
            track = SegmentTrack(np.zeros(ln, np.uint32),
                                 np.zeros(ln, bool),
                                 np.zeros(ln, np.uint32),
                                 np.zeros(ln, np.uint32)) \
                if need_tracks else None
            for a, b, lead, buf in self._seq_windows(codes, kcount):
                p = buf.shape[0] - k + 1
                self._classify_acc(jnp.asarray(buf), k, accs[si],
                                   a, b, lead, p, track)
            # the accumulators for this segment are no longer needed;
            # free them as we go so peak host RSS stays ~13 B/position
            del accs[si]
            self.tot_kcount += kcount
            if need_tracks:
                self.tracks.append(track)

    def _classify_acc(self, buf_d, k, acc, a, b, lead, p, track):
        """Classify one sequence window from host accumulators."""
        import jax.numpy as jnp

        from ..ops.validate import _classify_sel, _extract_ctx

        af, ac, ar, al = acc

        def pad(arr, fill, dtype):
            outb = np.full(p, fill, dtype)
            outb[lead:lead + (b - a)] = arr[a:b]
            return jnp.asarray(outb)

        _keys, isfw, valid, _ctx = _extract_ctx(buf_d, k)
        sel = (pad(af, False, bool), pad(ac, 0, np.uint32),
               pad(ar, 0, np.uint32), pad(al, 0, np.uint32))
        (valid, missing, edge_missing, cov, isfw, right,
         left) = _classify_sel(buf_d, sel, k, self.ui.cov_cutoff,
                               isfw=isfw, valid=valid)
        sl = slice(lead, lead + (b - a))
        self.tot_missing += int(np.asarray(missing[sl]).sum())
        self.tot_edge_missing += int(np.asarray(edge_missing[sl]).sum())
        if track is not None:
            track.cov[a:b] = np.asarray(cov[sl])
            track.isfw[a:b] = np.asarray(isfw[sl])
            track.right[a:b] = np.asarray(right[sl])
            track.left[a:b] = np.asarray(left[sl])

    def _print_qv(self, out, k: int) -> None:
        if "." in self.ui.out_file or self.ui.out_file == "":
            def qv(err: float) -> float:
                if math.isnan(err):
                    return float("nan")
                return -10 * math.log10(err) if err > 0 else float("inf")

            out.write("Missing\tTotal\tQV\tError\tk\tMethod\n")
            merr = error_rate(self.tot_missing, self.tot_kcount, k)
            out.write(f"{self.tot_missing}\t{self.tot_kcount}\t"
                      f"{cpp_double(qv(merr))}\t{cpp_double(merr)}\t{k}\t"
                      f"Merqury\n")
            kerr = error_rate(self.tot_missing + self.tot_edge_missing,
                              self.tot_kcount, k)
            out.write(f"{self.tot_missing + self.tot_edge_missing}\t"
                      f"{self.tot_kcount}\t{cpp_double(qv(kerr))}\t"
                      f"{cpp_double(kerr)}\t{k}\tKreeq\n")
