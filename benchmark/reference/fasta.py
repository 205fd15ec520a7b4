"""Plain FASTA records for the references: uncompressed files only, with the
semantics of geNomad's reader (genomad/sequence.py:96-121): records with
empty sequences are dropped, ``strip_n`` trims leading and trailing N/n."""

from __future__ import annotations

import textwrap

_RC_TABLE = bytes.maketrans(b"ACTGNactgn", b"TGACNtgacn")


class Sequence:
    __slots__ = ("header", "_seq")

    def __init__(self, header: str, seq) -> None:
        self.header = header
        self._seq = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)

    @property
    def accession(self) -> str:
        return self.header.split()[0]

    @property
    def seq(self) -> str:
        return self._seq.decode()

    @property
    def seq_ascii(self) -> bytes:
        return self._seq.upper()

    def rc(self) -> "Sequence":
        return Sequence(self.header, self._seq.translate(_RC_TABLE)[::-1])

    def __len__(self) -> int:
        return len(self._seq)

    def __str__(self) -> str:
        return f">{self.header}\n{textwrap.fill(self.seq, 60, break_on_hyphens=False)}\n"


def read_fasta(path, strip_n: bool = False):
    header, chunks = None, []

    def record():
        seq = "".join(chunks)
        if strip_n:
            seq = seq.strip("nN")
        return Sequence(header, seq) if seq else None

    with open(path) as fin:
        for line in fin:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None and (rec := record()) is not None:
                    yield rec
                header, chunks = line[1:], []
            elif header is not None:
                chunks.append(line)
    if header is not None and (rec := record()) is not None:
        yield rec
