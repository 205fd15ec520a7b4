"""The marker-profile DB of a configuration, made from the configuration's
own fixed seed and kept in a fixed, git-ignored directory of the checkout
(``benchmark/cache/<config>/``). The first run of a cell in a checkout
writes it; later runs find ``READY`` there, holding the recipe they need,
and write nothing. The port builds its own sidecars beside the profiles the
first time it loads them (the int8 PSSM and the k-mer index).

The directory is a geNomad DB directory in the port's packed format:
``version.txt``, ``genomad_profiles.npz`` (integral scores stored as int8,
uncompressed), ``genomad_mini_profiles.npz`` (a link to it), a 16-profile
integrase DB, the 17-column marker metadata and a minimal taxdump. Beside
it, ``consensus.npy`` and ``offsets.npy`` are the benchmark's own: the
traffic plants genes from them and the reference reads the profiles from
the npz, never from the port.

Recipe (a profile per marker): lengths uniform in [min_len, max_len]; a
consensus residue per column drawn from background amino-acid frequencies;
scores N(-2, 0.7) with U(5, 9) added on the consensus residue, rounded to
integers (real profile scores are small integers); odd profiles are virus
markers (VV), even ones chromosome markers (CC).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "cache"
N_AA = 20
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
# UniProt-scale background frequencies in the alphabet's order
BACKGROUND_FREQS = np.array(
    [0.074, 0.025, 0.054, 0.054, 0.047, 0.074, 0.026, 0.068, 0.058, 0.099,
     0.025, 0.045, 0.039, 0.034, 0.052, 0.057, 0.051, 0.073, 0.013, 0.032]
)
BACKGROUND_FREQS = BACKGROUND_FREQS / BACKGROUND_FREQS.sum()
_BLOCK = 4096  # profiles drawn per generator stream


def _profiles(n: int, seed: int, min_len: int, max_len: int, freqs, integral: bool):
    """(lengths int32, offsets int64, pssm (total, 20) int8 or float32)."""
    lengths = np.random.default_rng([seed, 1 << 20]).integers(min_len, max_len + 1, n).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    pssm = np.empty((int(offsets[-1]), N_AA), np.int8 if integral else np.float32)
    for b, s in enumerate(range(0, n, _BLOCK)):
        rng = np.random.default_rng([seed, b])
        lo, hi = int(offsets[s]), int(offsets[min(s + _BLOCK, n)])
        m = hi - lo
        consensus = rng.choice(N_AA, m, p=freqs) if freqs is not None else rng.integers(0, N_AA, m)
        block = rng.normal(-2.0, 0.7, (m, N_AA)).astype(np.float32)
        block[np.arange(m), consensus] += rng.uniform(5.0, 9.0, m).astype(np.float32)
        pssm[lo:hi] = np.clip(np.round(block), -127, 127) if integral else block
    return lengths, offsets, pssm


def _save_npz(path: Path, names, lengths, taxids, pssm, offsets) -> None:
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, names=names, lengths=lengths, taxids=taxids, pssm=pssm, offsets=offsets)
    tmp.replace(path)


def _write_metadata(db_dir: Path, names) -> None:
    header = "\t".join(
        ["marker", "c1", "class", "c3", "spm_c", "spm_p", "spm_v", "gv", "uscg", "ph",
         "vh", "conjscan", "amr", "acc", "desc", "t1", "t2"]
    )
    lines = [header]
    for i, name in enumerate(names):
        spec, spm = ("VV", ("0.1", "0.2", "0.9")) if i % 2 else ("CC", ("0.9", "0.2", "0.1"))
        lines.append(
            f"{name}\tx\t{spec}\tx\t{spm[0]}\t{spm[1]}\t{spm[2]}\t0\tNA\t0\t"
            f"{i % 2}\tNA\tNA\tPF{i:05d}\tdesc{i}\tx\tx"
        )
    (db_dir / "genomad_marker_metadata.tsv").write_text("\n".join(lines) + "\n")
    with open(db_dir / "nodes.dmp", "w") as f:
        for tx, parent, rank in [(1, 1, "no rank"), (10, 1, "realm")]:
            f.write(f"{tx}\t|\t{parent}\t|\t{rank}\t|\n")
    with open(db_dir / "names.dmp", "w") as f:
        for tx, name in [(1, "root"), (10, "Duplodnaviria")]:
            f.write(f"{tx}\t|\t{name}\t|\t\t|\tscientific name\t|\n")


class MarkerDB:
    """The benchmark's view of a configuration's DB: where it lies, and the
    consensus of any marker or integrase profile for the traffic."""

    def __init__(self, base: Path, recipe: dict):
        self.base = base
        self.db_dir = base / "db"
        self.recipe = recipe
        self.n_profiles = int(recipe["profiles"])
        self._consensus = np.load(base / "consensus.npy", mmap_mode="r")
        self._offsets = np.load(base / "offsets.npy")
        self.integrase_consensus = [np.asarray(c) for c in np.load(base / "integrase_consensus.npz").values()]

    def consensus(self, i: int) -> np.ndarray:
        return np.asarray(self._consensus[self._offsets[i] : self._offsets[i + 1]])

    def profiles_file(self) -> Path:
        return self.db_dir / "genomad_profiles.npz"


def ensure_db(config_name: str, recipe: dict, cache: Path = CACHE) -> tuple[MarkerDB, bool]:
    """The configuration's DB, written first if ``READY`` does not hold
    this recipe. Returns (db, whether it was written now)."""
    base = cache / config_name
    ready = base / "READY"
    if ready.exists() and json.loads(ready.read_text()) == recipe:
        return MarkerDB(base, recipe), False
    if base.exists():
        shutil.rmtree(base)
    db_dir = base / "db"
    db_dir.mkdir(parents=True)
    n = int(recipe["profiles"])
    lengths, offsets, pssm = _profiles(
        n, int(recipe["seed"]), int(recipe["min_len"]), int(recipe["max_len"]), BACKGROUND_FREQS, True
    )
    names = np.array([f"GENOMAD.{i:06d}.XX" for i in range(n)])
    taxids = np.random.default_rng([int(recipe["seed"]), 1 << 21]).integers(0, 1000, n).astype(np.int32)
    (db_dir / "version.txt").write_text("1.9\n")
    _save_npz(db_dir / "genomad_profiles.npz", names, lengths, taxids, pssm, offsets)
    os.symlink("genomad_profiles.npz", db_dir / "genomad_mini_profiles.npz")
    ni = int(recipe["integrase_profiles"])
    i_len, i_off, i_pssm = _profiles(
        ni, int(recipe["integrase_seed"]), int(recipe["integrase_len"][0]), int(recipe["integrase_len"][1]), None, False
    )
    _save_npz(
        db_dir / "genomad_integrase_profiles.npz", np.array([f"INTEGRASE.{i:03d}" for i in range(ni)]),
        i_len, np.zeros(ni, np.int32), i_pssm, i_off,
    )
    _write_metadata(db_dir, names)
    np.save(base / "consensus.npy", pssm.argmax(1).astype(np.int8))
    np.save(base / "offsets.npy", offsets)
    i_cons = i_pssm.argmax(1).astype(np.int8)
    np.savez(base / "integrase_consensus.npz", *[i_cons[i_off[i] : i_off[i + 1]] for i in range(ni)])
    ready.write_text(json.dumps(recipe))
    return MarkerDB(base, recipe), True


def load_profiles(path: Path, ids) -> tuple[list, np.ndarray]:
    """The float32 PSSMs (L, 20) of profiles ``ids`` and all profile
    lengths, read from the packed npz (the reference's raw input)."""
    with np.load(path, allow_pickle=False) as npz:
        offsets = npz["offsets"].astype(np.int64)
        lengths = npz["lengths"].astype(np.int64)
        pssm = npz["pssm"]
    return [pssm[offsets[i] : offsets[i + 1]].astype(np.float32) for i in ids], lengths
