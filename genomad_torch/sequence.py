"""Sequence core: FASTA IO, windowing and base codes.

Copied from ``genomad_tpu/sequence.py`` (the parts nn-classification uses).
Reference = apcamargo/genomad v1.12.0:
  - Sequence semantics:     genomad/sequence.py:10-93
  - streaming FASTA reader: genomad/sequence.py:96-121
  - 6 kb windowing:         genomad/sequence.py:150-166
"""

from __future__ import annotations

import numpy as np

from genomad_torch import utils

# Base -> 2-bit code; anything not ACGT (uppercase) -> 4 (invalid sentinel).
_BASE_CODES = np.full(256, 4, dtype=np.int64)
for _b, _c in zip(b"ACGT", range(4)):
    _BASE_CODES[_b] = _c


class Sequence:
    """A named nucleotide (or protein) sequence."""

    __slots__ = ("_header", "_seq")

    def __init__(self, header: str, seq: str) -> None:
        self._header = header
        self._seq = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)

    @property
    def accession(self) -> str:
        return self._header.split()[0]

    @property
    def seq_ascii(self) -> bytes:
        return self._seq.upper()

    def count(self, substring: str) -> int:
        return self._seq.count(substring.encode("ascii"))

    def __len__(self) -> int:
        return len(self._seq)

    def __getitem__(self, k) -> "Sequence":
        return Sequence(self._header, self._seq[k].decode())


def read_fasta(filepath, strip_n: bool = False):
    """Stream Sequence records from a (possibly compressed) FASTA file.

    Mirrors reference semantics (genomad/sequence.py:96-121): records with
    empty sequences are dropped; ``strip_n`` trims leading/trailing N/n.
    """
    with utils.open_file(filepath) as fin:
        header = None
        chunks: list[str] = []
        for line in fin:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    seq = "".join(chunks)
                    if strip_n:
                        seq = seq.strip("nN")
                    if seq:
                        yield Sequence(header, seq)
                header = line[1:]
                chunks = []
            elif header is not None:
                chunks.append(line)
        if header is not None:
            seq = "".join(chunks)
            if strip_n:
                seq = seq.strip("nN")
            if seq:
                yield Sequence(header, seq)


def check_fasta(filepath) -> bool:
    """False if the FASTA is empty or has duplicate accessions
    (reference: genomad/sequence.py:124-131)."""
    accessions = [seq.accession for seq in read_fasta(filepath)]
    return bool(accessions) and len(accessions) == len(set(accessions))


def seq_windows(seq: Sequence, length: int, min_length: int = 0, force_first_window: bool = True, max_windows=None):
    """Yield fixed-length windows over a sequence (reference: sequence.py:150-166).

    The final short window is dropped unless it is the first window and
    ``force_first_window`` is set (short contigs still get one window).
    """
    win = 0
    while win * length < len(seq):
        window = seq[win * length : (win + 1) * length]
        if len(window) < min_length:
            if win == 0 and force_first_window:
                yield window
            break
        yield window
        win += 1
        if max_windows and win == max_windows:
            break
