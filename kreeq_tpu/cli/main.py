"""kreeq CLI: argv-compatible front end (reference: src/main.cpp).

Modes: validate, union, subgraph (reference: src/main.cpp:61-65).
Multi-value -r/-d consume following non-option arguments exactly like
the reference's optind loop (reference: src/main.cpp:169-179).
"""

from __future__ import annotations

import os
import sys
from typing import List

from ..config import UserInput, get_file_ext

VERSION = "0.1.0"


def _err(msg: str) -> "None":
    sys.stderr.write(msg)
    sys.exit(1)


def print_help() -> None:
    print("kreeq [mode] -h\nfor additional help.\n")
    print("Modes:")
    print("validate")
    print("union")
    print("subgraph")
    sys.exit(0)


_LONG = {
    "--coverage-cutoff": "c", "--database": "d", "--databases": "d",
    "--input-positions": "p", "--input-sequence": "f", "--kmer-length": "k",
    "--out-format": "o", "--input-reads": "r", "--tmp-prefix": "t",
    "--max-memory": "m", "--threads": "j",
}
_FLAGS = {"--verbose": "verbose", "--cmd": "cmd", "--no-collapse":
          "no_collapse", "--no-reference": "no_reference",
          "--profile": "profile"}
_LONG_VALUED = {"--search-depth": "kmer_depth", "--max-span": "max_span",
                "--traversal-algorithm": "trav_algorithm",
                "--detect-anomalies": "anomalies_out",
                "--trace-dir": "trace_dir"}


def parse_args(argv: List[str]) -> UserInput:
    if len(argv) <= 2:
        print_help()
    modes = {"validate": 0, "union": 1, "subgraph": 2}
    if argv[1] not in modes:
        _err(f"mode {argv[1]} does not exist. Terminating\n")
    ui = UserInput(mode=modes[argv[1]])
    cmd_flag = False

    i = 2
    n = len(argv)

    def multi(start: int, dest: list) -> int:
        j = start
        while j < n and (argv[j] == "-" or not argv[j].startswith("-")):
            # "-" = stdin (reference StreamObj pipe support; the
            # snapshot CLI's isPipe branch is dead — see io/fastx.py)
            if argv[j] != "-" and not os.path.exists(argv[j]):
                _err(f"--file {argv[j]} does not exist.\n")
            dest.append(argv[j])
            j += 1
        return j

    def value_of(idx: int, opt: str) -> str:
        if idx >= n:
            _err(f"option {opt} is missing a required argument\n")
        return argv[idx]

    while i < n:
        a = argv[i]
        if a in _FLAGS:
            if a == "--cmd":
                cmd_flag = True
            else:
                setattr(ui, _FLAGS[a], True)
            i += 1
            continue
        if a in _LONG_VALUED:
            val = value_of(i + 1, a)
            dest = _LONG_VALUED[a]
            if dest in ("trav_algorithm", "anomalies_out", "trace_dir"):
                setattr(ui, dest, val)
            else:
                setattr(ui, dest, int(val))
            i += 2
            continue
        short = _LONG.get(a, a[1:] if a.startswith("-") and len(a) == 2
                          else None)
        if short is None:
            _err(f"Unrecognized option: {a}\n")
        if short == "h":
            print("kreeq [command]")
            sys.exit(0)
        if short == "v":
            print(f"kreeq v{VERSION}")
            sys.exit(0)
        if short == "r":
            i = multi(i + 1, ui.in_reads)
            continue
        if short == "d":
            i = multi(i + 1, ui.kmer_db)
            continue
        val = value_of(i + 1, a)
        if short == "c":
            ui.cov_cutoff = int(val)
        elif short == "f":
            if val != "-" and not os.path.exists(val):
                _err(f"--file {val} does not exist.\n")
            ui.in_sequence = val
        elif short == "k":
            ui.kmer_len = int(val)
        elif short == "o":
            ui.out_file = val
        elif short == "p":
            ui.in_bed_include = val
        elif short == "t":
            ui.prefix = val
        elif short == "m":
            ui.max_mem = float(val)
        elif short == "j":
            ui.threads = int(val)
        else:
            _err(f"Unrecognized option: {a}\n")
        i += 2

    if cmd_flag:
        print(" ".join(argv) + " ")
    if ui.mode == 1 and len(ui.kmer_db) < 2:
        _err("At least two databases required (-d).\n")
    if ui.mode == 2 and len(ui.kmer_db) != 1:
        _err("Need to provide one database (-d).\n")
    return ui


def load_graph(ui: UserInput):
    """Load a .kreeq DB, overriding -k with the DB's k (reference:
    src/input.cpp:56-74)."""
    from ..io.kreeqdb import read_kreeq

    if len(ui.kmer_db) == 1:
        table = read_kreeq(ui.kmer_db[0])
        ui.kmer_len = table.k
        return table
    if len(ui.kmer_db) > 1:
        _err("More than one DBG database provided. Merge them first. "
             "Exiting.\n")
    _err("Cannot load DBG input. Exiting.\n")


def run(argv: List[str]) -> int:
    if len(argv) > 1 and argv[1] == "warmup":
        # pre-compile the standard shape grid into the persistent
        # cache (cold-start mitigation)
        from .warmup import run as warmup_run

        return warmup_run(argv)
    ui = parse_args(argv)

    from ..core.dbg import DBG
    from ..core.table import KmerTable
    from ..io.fastx import load_genome
    from ..io.sequence import Genome
    from ..parallel import multihost
    from ..utils import log

    # multi-host launch (KREEQ_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID
    # set by the pod launcher): the DB build is distributed over the
    # global mesh; every host ends with the full table, the rest of the
    # pipeline runs replicated and only process 0 prints
    distributed = multihost.maybe_initialize()
    if distributed:
        import io as _io

        import jax

        if jax.process_index() != 0:
            sys.stdout = _io.StringIO()

    log.set_flags(ui.verbose, getattr(ui, "profile", False))
    if ui.max_mem or ui.threads:
        # accepted for argv compatibility; the device pipeline plans
        # static chunk/window sizes instead of a reactive memory
        # governor or a thread pool (SURVEY P7: reference
        # src/main.cpp:432-433)
        log.verbose("Note: -m/--max-memory and -j/--threads are "
                    "accepted for compatibility but not used; batch "
                    "sizes are planned statically (KREEQ_TPU_CHUNK).")
    if ui.trace_dir:
        log.maybe_start_jax_profiler(ui.trace_dir)

    if ui.mode == 0:  # validate (reference: src/input.cpp:86-118)
        if ui.in_reads:
            log.verbose("Loading input reads.")
            with log.phase("build k-mer DB"):
                if distributed:
                    import jax

                    mine = multihost.shard_read_files(
                        ui.in_reads, jax.process_count(),
                        jax.process_index())
                    table = multihost.build_table_distributed(
                        mine, ui.kmer_len)
                else:
                    table = KmerTable.from_reads(ui.in_reads, ui.kmer_len)
            log.verbose("Reads loaded.")
        else:
            with log.phase("load k-mer DB"):
                table = load_graph(ui)
        dbg = DBG(ui, table)
        if ui.in_sequence:
            log.verbose("Loading input sequences")
            with log.phase("load genome"):
                genome = Genome()
                load_genome(ui.in_sequence, genome)
                dbg.load_genome(genome)
            log.verbose("Sequences loaded")
        with log.phase("report"):
            report(dbg)
        if ui.anomalies_out:
            from ..core.variants import write_anomalies

            with log.phase("detect anomalies"):
                write_anomalies(dbg, ui.anomalies_out)
        log.print_profile()
        if ui.trace_dir:
            log.maybe_stop_jax_profiler()
    elif ui.mode == 1:  # union (reference: src/input.cpp:119-152)
        from ..io.kreeqdb import read_index, read_kreeq

        k = 0
        for db in ui.kmer_db:
            dbk, _mc = read_index(db)
            if k == 0:
                k = dbk
            if k != dbk:
                _err("Cannot merge databases with different kmer length.\n")
        if k == 0 or k > 32:
            _err("Invalid kmer length.\n")
        ui.kmer_len = k
        table = KmerTable.empty(k)
        for db in ui.kmer_db:
            table = table.merge(read_kreeq(db))
        dbg = DBG(ui, table)
        report(dbg)
    elif ui.mode == 2:  # subgraph (reference: src/input.cpp:153-181)
        from ..core.subgraph import run_subgraph

        table = load_graph(ui)
        dbg = DBG(ui, table)
        if ui.in_sequence:
            genome = Genome()
            load_genome(ui.in_sequence, genome)
            dbg.load_genome(genome)
        run_subgraph(dbg)
        report(dbg)
    return 0


def report(dbg) -> None:
    """Output dispatch by extension (reference:
    src/kreeq-output.cpp:34-136)."""
    ui = dbg.ui
    ext = "stdout" if ui.out_file == "" else get_file_ext("." + ui.out_file)

    if "." in ui.out_file or ui.out_file == "" or ext == "kreeq" \
            or ui.stats_flag:
        dbg.print_db_stats()

    computed = {"kreeq": 1, "bed": 2, "csvtable": 2, "kwig": 3,
                "bkwig": 4, "gfa": 5, "gfa2": 5, "gfa.gz": 5, "gfa2.gz": 5,
                "vcf": 6, "hist": 7}
    case = computed.get(ext, 0)

    if ui.mode == 0:
        if case in (5, 6):
            from ..core.variants import correct_sequences

            correct_sequences(dbg)
        else:
            # per-base tracks feed only the bed/csv/kwig/bkwig writers
            # (reference: src/kreeq-output.cpp:62-83); plain validate /
            # .kreeq / hist take the sums-only fast path
            dbg.validate_sequences(need_tracks=case in (2, 3, 4))

    from ..io import writers

    if case == 1:
        from ..io.kreeqdb import write_kreeq

        write_kreeq(ui.out_file, dbg.table)
    elif case == 2:
        writers.print_table(dbg, ext)
    elif case == 3:
        writers.print_kwig(dbg)
    elif case == 4:
        writers.print_bkwig(dbg)
    elif case == 5:
        writers.print_gfa(dbg)
    elif case == 6:
        writers.print_vcf(dbg)
    elif case == 7:
        writers.print_hist(dbg)


def main() -> None:
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
