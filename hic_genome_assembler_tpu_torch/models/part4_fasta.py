"""Part 4 — emit the assembled FASTA.

Concatenates scaffolds per chromosome in final order/orientation with
100-N gaps, reverse-complementing "-" scaffolds; scaffolds absent from
the ordering pass through under their original names.  Byte-equal output
target vs writeAssembledFasta.py:76-128.
"""

from __future__ import annotations

import time
from typing import Dict, List

from hic_genome_assembler_tpu_torch.io.fasta import (
    read_fasta,
    reverse_complement,
    write_wrapped_seq,
)
from hic_genome_assembler_tpu_torch.io.filebus import read_chromosome_ordering
from hic_genome_assembler_tpu_torch.utils import profiling


def write_new_fasta(
    chr_groups: List[List[List[str]]],
    old_fasta: Dict[str, str],
    out_path: str,
    chars_per_line: int = 50,
    n_gap_length: int = 100,
) -> Dict[str, int]:
    """Assemble and write the new FASTA; returns the assembly stats.

    Mirrors writeAssembledFasta.py:76-128: ``>Chr_i`` headers in group
    order, "-" scaffolds reverse-complemented, ``n_gap_length`` Ns
    between joined scaffolds (not after the last), then every unwritten
    input entry verbatim in input order.
    """
    grouped_len = ungrouped_len = 0
    new_ns = gaps = 0
    grouped = ungrouped = 0
    written: Dict[str, str] = {}

    with open(out_path, "w") as out:
        for i, group in enumerate(chr_groups, 1):
            out.write(f">Chr_{i}\n")
            parts: List[str] = []
            for idx, (name, orientation) in enumerate(group):
                grouped += 1
                written[name] = ""
                seq = old_fasta[name]
                parts.append(seq if orientation == "+" else reverse_complement(seq))
                if idx != len(group) - 1:
                    parts.append("N" * n_gap_length)
                    new_ns += n_gap_length
                    gaps += 1
            joined = "".join(parts)
            grouped_len += len(joined)
            write_wrapped_seq(out, joined, chars_per_line)

        for name, seq in old_fasta.items():
            if name not in written:
                out.write(f">{name}\n")
                ungrouped_len += len(seq)
                ungrouped += 1
                write_wrapped_seq(out, seq, chars_per_line)

    print("Total scaffolds grouped into chromosomes\t" + str(grouped))
    print("Total genome length grouped into chromosomes\t" + str(grouped_len - new_ns))
    print("Total new gaps introduced\t" + str(gaps))
    print("Total ungrouped scaffolds\t" + str(ungrouped))
    print("Total genome length ungrouped \t" + str(ungrouped_len))
    return {
        "scaffolds_grouped": grouped,
        "grouped_length": grouped_len - new_ns,
        "gaps": gaps,
        "ungrouped_scaffolds": ungrouped,
        "ungrouped_length": ungrouped_len,
    }


def run_pipeline(
    original_fasta_file: str,
    final_ordering_file: str,
    assembled_fasta_file: str,
) -> None:
    """Part 4 driver (writeAssembledFasta.py:133-142)."""
    print("########################################")
    print("### Working on Part4 of the pipeline ###")
    start = time.time()
    with profiling.timer("part4/read_draft"):
        fasta = read_fasta(original_fasta_file)
        groups = read_chromosome_ordering(final_ordering_file)
    with profiling.timer("part4/write"):
        write_new_fasta(groups, fasta, assembled_fasta_file, chars_per_line=50, n_gap_length=100)
    print("Total run-time  for Part4 = " + str(time.time() - start))
    print("- Part 4 (writing of new super-scaffolded genome .fasta) completed successfully")
