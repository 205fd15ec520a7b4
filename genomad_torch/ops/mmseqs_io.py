"""MMseqs2 profile-database reader: converts the geNomad distribution's
MMseqs2 profile DBs into the packed PSSM arrays the search engine
consumes.

The geNomad DB ships three MMseqs2 profile databases (genomad_db /
genomad_mini_db / genomad_integrase_db — reference genomad/database.py:18-29).
MMseqs2 profile serialization (BaseMatrix/Profile layout, MMseqs2 >= 13):
each database entry is a flat array of per-position records of
``PROFILE_READIN_SIZE`` bytes:

    20 x int8   biased substitution scores (stored = round(bitscore * 4))
     1 x uint8  query residue index
     1 x uint8  consensus residue index
     1 x uint8  neff (discretized)
  [ + 2 x uint8 gap penalties in newer versions ]

The record size is auto-detected from divisibility of the entry length;
the int8 scores are rescaled to bits (score / 4.0). Entry names come from
the ``.lookup`` file, taxids from ``_mapping``.

A copy of ``genomad_tpu/ops/mmseqs_io.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from genomad_torch.ops.profiledb import N_AA, ProfileDB

_RECORD_SIZES = (23, 25, 27)  # bytes per profile position, version-dependent
_SCORE_SCALE = 4.0  # stored int8 = round(bitscore * 4)

# (MMseqs2 db name in the distribution, packed output filename)
PACKED_TARGETS = (
    ("genomad_db", "genomad_profiles.npz"),
    ("genomad_mini_db", "genomad_mini_profiles.npz"),
    ("genomad_integrase_db", "genomad_integrase_profiles.npz"),
)


def read_mmseqs_index(db_path: Path) -> dict[int, tuple[int, int]]:
    """Parse the MMseqs2 .index file: entry_id -> (offset, length)."""
    entries = {}
    with open(f"{db_path}.index") as fin:
        for line in fin:
            entry_id, offset, length = line.split()
            entries[int(entry_id)] = (int(offset), int(length))
    return entries


def read_mmseqs_lookup(db_path: Path) -> dict[int, str]:
    """Parse the .lookup file: entry_id -> name."""
    names = {}
    lookup = Path(f"{db_path}.lookup")
    if not lookup.exists():
        return names
    with open(lookup) as fin:
        for line in fin:
            fields = line.split()
            names[int(fields[0])] = fields[1]
    return names


def read_mmseqs_taxid_mapping(db_path: Path) -> dict[int, int]:
    """Parse the _mapping file: entry_id -> taxid."""
    taxids = {}
    mapping = Path(f"{db_path}_mapping")
    if not mapping.exists():
        return taxids
    with open(mapping) as fin:
        for line in fin:
            fields = line.split()
            taxids[int(fields[0])] = int(fields[1])
    return taxids


def detect_record_size(entry_lengths) -> int:
    """Profile record size = the candidate that divides every entry
    (entries may carry a single trailing NUL)."""
    for size in _RECORD_SIZES:
        if all((l - 1) % size == 0 or l % size == 0 for l in entry_lengths):
            return size
    raise ValueError(
        f"cannot detect MMseqs2 profile record size from entry lengths "
        f"{sorted(set(entry_lengths))[:5]}..."
    )


def convert_mmseqs_profile_db(db_path: Path) -> ProfileDB:
    """Read one MMseqs2 profile DB (data + .index + .lookup + _mapping)
    into a packed ProfileDB."""
    db_path = Path(db_path)
    index = read_mmseqs_index(db_path)
    names_map = read_mmseqs_lookup(db_path)
    taxid_map = read_mmseqs_taxid_mapping(db_path)
    data = Path(db_path).read_bytes() if Path(db_path).exists() else None
    if data is None:
        # split data files (genomad_db.0, .1, ...) are concatenated
        parts = sorted(db_path.parent.glob(db_path.name + ".[0-9]*"))
        if not parts:
            raise FileNotFoundError(f"{db_path} data file not found")
        data = b"".join(p.read_bytes() for p in parts)
    lengths = [l for _, l in index.values()]
    record = detect_record_size(lengths)
    names, pssms, taxids = [], [], []
    for entry_id in sorted(index):
        offset, length = index[entry_id]
        n_positions = length // record
        raw = np.frombuffer(data, np.int8, count=n_positions * record, offset=offset)
        raw = raw.reshape(n_positions, record)
        scores = raw[:, :N_AA].astype(np.float32) / _SCORE_SCALE
        names.append(names_map.get(entry_id, f"ENTRY_{entry_id}"))
        pssms.append(scores)
        taxids.append(taxid_map.get(entry_id, 0))
    return ProfileDB.from_profiles(names, pssms, np.asarray(taxids, np.int32))


def build_packed_dbs(db_dir: Path, console=None, force: bool = False) -> list[Path]:
    """Convert every MMseqs2 profile DB present in ``db_dir`` into the
    packed native format (skipping up-to-date outputs unless ``force``).

    Returns the list of packed files written or already present.
    """
    db_dir = Path(db_dir)
    written = []
    for src, dst in PACKED_TARGETS:
        src_index = db_dir / f"{src}.index"
        out = db_dir / dst
        if not src_index.exists():
            if not out.exists() and console is not None:
                console.warning(f"{src}.index not found in {db_dir}; skipping {dst}.")
            continue
        if out.exists() and not force:
            written.append(out)
            continue
        db = convert_mmseqs_profile_db(db_dir / src)
        db.save(out)
        written.append(out)
        if console is not None:
            console.log(
                f"Packed {src} -> {dst}: {db.n_profiles} profiles, "
                f"{db.total_positions:,} positions."
            )
    return written
