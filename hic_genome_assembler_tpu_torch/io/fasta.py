"""FASTA reading, reverse complement, and fixed-width sequence writing.

Byte-format contract (writeAssembledFasta.py:10-74): 50 chars per line,
no trailing blank line for sequences whose length is a multiple of the
width, reverse complement defined for ACGTN upper/lower ONLY (any other
IUPAC code raises, matching the reference's KeyError behavior at
writeAssembledFasta.py:59-63).

Throughput: a 1.6 Gb genome is ~32M FASTA lines, so both directions are
bulk byte operations (one read + split / one numpy reshape + write)
instead of per-line Python loops — byte-identical output, ~C speed.
"""

from __future__ import annotations

import gzip
from typing import Dict

import numpy as np

_COMPLEMENT = bytes.maketrans(b"ATGCatgcNn", b"TACGtacgNn")
_VALID = frozenset(b"ATGCatgcNn")


def read_fasta(path: str) -> Dict[str, str]:
    """Whole FASTA (plain or .gz) into {name: sequence}
    (writeAssembledFasta.py:10-32).

    Bulk parse: one read, split on entry boundaries, newline-strip per
    entry.  Same semantics as the reference's line loop for well-formed
    FASTA: name = full header line after ">", sequence = concatenation
    of its lines, duplicate names keep the LAST entry.  Malformed-input
    behavior mirrors the reference where it matters: content before the
    first header raises (the reference's line loop dies on an undefined
    ``chrName``, writeAssembledFasta.py:22-25).  ``\\r`` handling is the
    reference's: text mode reads with universal newlines, so lone or
    paired ``\\r`` act as line breaks in both implementations.  Sole
    documented relaxation: blank lines are skipped rather than raising
    IndexError.
    """
    opener = gzip.open if ".gz" in path else open
    with opener(path, mode="rt") as handle:
        # text mode == universal newlines: \r\n and lone \r arrive as \n,
        # exactly as the reference's line loop sees them
        data = handle.read()
    seqs: Dict[str, str] = {}
    if not data:
        return seqs
    start = data.find(">")
    if start == -1:
        raise ValueError(f"{path}: no FASTA headers found")
    if data[:start].strip():
        raise ValueError(f"{path}: FASTA content before the first '>' header")
    for entry in data[start + 1 :].split("\n>"):
        nl = entry.find("\n")
        if nl == -1:
            seqs[entry] = ""
        else:
            seqs[entry[:nl]] = entry[nl + 1 :].replace("\n", "")
    return seqs


def reverse_complement(seq: str) -> str:
    """Reverse complement over the strict ACGTN alphabet
    (writeAssembledFasta.py:55-63)."""
    raw = seq.encode("ascii")
    bad = set(raw) - _VALID
    if bad:
        raise KeyError(chr(sorted(bad)[0]))
    return raw.translate(_COMPLEMENT)[::-1].decode("ascii")


def write_wrapped_seq(handle, seq: str, chars_per_line: int = 50) -> None:
    """Fixed-width sequence emission (writeAssembledFasta.py:65-74).

    One numpy reshape inserts the newline column for the full-width
    lines; the ragged tail (if any) is appended with its own newline.
    Byte-identical to the per-line loop, ~100x fewer Python operations
    at genome scale.
    """
    n = len(seq)
    if n == 0:
        return
    raw = seq.encode("ascii")
    full = n // chars_per_line
    out = bytearray()
    if full:
        arr = np.frombuffer(raw, dtype=np.uint8, count=full * chars_per_line)
        block = np.empty((full, chars_per_line + 1), dtype=np.uint8)
        block[:, :chars_per_line] = arr.reshape(full, chars_per_line)
        block[:, chars_per_line] = ord("\n")
        out += block.tobytes()
    tail = raw[full * chars_per_line :]
    if tail:
        out += tail + b"\n"
    handle.write(out.decode("ascii"))
