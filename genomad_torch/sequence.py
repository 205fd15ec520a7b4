"""Sequence core: FASTA IO, windowing, terminal repeats and base codes.

Copied from ``genomad_tpu/sequence.py`` (all but the k-mer tokenizer: the
port's classifier takes base codes). Reference = apcamargo/genomad v1.12.0:
  - Sequence semantics (rc / DTR / ITR / formatting): genomad/sequence.py:10-93
  - streaming FASTA reader:                           genomad/sequence.py:96-121
  - 6 kb windowing generator:                         genomad/sequence.py:150-166
"""

from __future__ import annotations

import textwrap
from pathlib import Path

import numpy as np

from genomad_torch import utils

_RC_TABLE = bytes.maketrans(b"ACTGNactgn", b"TGACNtgacn")

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
    def header(self) -> str:
        return self._header

    @property
    def accession(self) -> str:
        return self._header.split()[0]

    @property
    def seq(self) -> str:
        return self._seq.decode()

    @property
    def seq_ascii(self) -> bytes:
        return self._seq.upper()

    def count(self, substring: str) -> int:
        return self._seq.count(substring.encode("ascii"))

    def rc(self) -> "Sequence":
        return Sequence(self._header, self._seq.translate(_RC_TABLE)[::-1].decode())

    def has_dtr(self, min_length: int = 21) -> bool:
        """Direct terminal repeat >= min_length bp (reference: sequence.py:45-51)."""
        seq = self._seq.lower()
        substring = seq[:min_length]
        pos = seq.rfind(substring)
        if pos < len(seq) / 2:
            return False
        substring = seq[pos:]
        return seq[: len(substring)] == substring

    def has_itr(self, min_len: int = 21) -> bool:
        """Inverted terminal repeat >= min_len bp (reference: sequence.py:53-55)."""
        return self._seq.lower()[:min_len] == self.rc()._seq.lower()[:min_len]

    def __str__(self) -> str:
        return f">{self._header}\n{textwrap.fill(self.seq, 60, break_on_hyphens=False)}\n"

    def __repr__(self) -> str:
        if len(self) > 40:
            seq = f"{self.seq[:34]}...{self.seq[-3:]}"
        else:
            seq = self.seq
        return f"Sequence({self.accession}, {seq})"

    def __len__(self) -> int:
        return len(self._seq)

    def __getitem__(self, k) -> "Sequence":
        return Sequence(self._header, self._seq[k].decode())

    def __eq__(self, other) -> bool:
        if isinstance(other, Sequence):
            return self._seq.lower() == other._seq.lower()
        if isinstance(other, str):
            return self._seq.lower() == other.encode("ascii").lower()
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._seq.lower())

    def __add__(self, other) -> "Sequence":
        if not isinstance(other, Sequence):
            return NotImplemented
        return Sequence(f"{self.accession}+{other.accession}", self.seq + other.seq)


def read_fasta(filepath, uppercase: bool = False, strip_n: bool = False):
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
                    if uppercase:
                        seq = seq.upper()
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
            if uppercase:
                seq = seq.upper()
            if strip_n:
                seq = seq.strip("nN")
            if seq:
                yield Sequence(header, seq)


def check_fasta(filepath) -> bool:
    """False if the FASTA is empty or has duplicate accessions
    (reference: genomad/sequence.py:124-131)."""
    accessions = [seq.accession for seq in read_fasta(filepath)]
    return bool(accessions) and len(accessions) == len(set(accessions))


def count_seqs(filepath: Path) -> int:
    return sum(line.startswith(">") for line in utils.read_file(filepath))


def filter_fasta(input_filepath, output_filepath, selected_seqs, ignore_gene_suffix: bool = False) -> None:
    """Copy selected records to a new FASTA (reference: sequence.py:138-147)."""
    with open(output_filepath, "w") as fout:
        for seq in read_fasta(input_filepath):
            name = seq.accession.rsplit("_", 1)[0] if ignore_gene_suffix else seq.accession
            if name in selected_seqs:
                fout.write(f"{seq}\n")


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

