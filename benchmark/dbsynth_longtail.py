"""A marker-profile DB whose lengths follow a log-normal law, as protein
lengths do, written in ``dbsynth``'s layout (``benchmark/cache/<config>/``:
the geNomad DB directory in the port's packed format, ``consensus.npy``,
``offsets.npy``, ``integrase_consensus.npz`` and ``READY`` holding the
recipe). The first run of a cell in a checkout writes it; a directory whose
``READY`` holds another recipe is written anew.

Recipe (the configuration's ``db``): ``profiles`` lengths drawn from the
seed's own stream, log-normal with the stated ``median`` and ``sigma``,
rounded and clipped to [``min``, ``max``]; each profile's columns by
``dbsynth``'s recipe, a block of 4,096 profiles per generator stream
(consensus residues from background frequencies, scores N(-2, 0.7) with
U(5, 9) on the consensus residue, rounded to integers); the integrase DB,
the metadata and the taxdump exactly as ``dbsynth`` writes them.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

from benchmark import dbsynth
from benchmark.dbsynth import BACKGROUND_FREQS, CACHE, N_AA, MarkerDB

_LENGTHS_STREAM = 1 << 22  # apart from dbsynth's streams of the same seed


def lengths(recipe: dict) -> np.ndarray:
    """The profiles' lengths (int32) that ``recipe`` states."""
    law = recipe["lengths"]
    rng = np.random.default_rng([int(recipe["seed"]), _LENGTHS_STREAM])
    drawn = rng.lognormal(np.log(float(law["median"])), float(law["sigma"]), int(recipe["profiles"]))
    return np.clip(np.round(drawn), int(law["min"]), int(law["max"])).astype(np.int32)


def _profiles(lens: np.ndarray, seed: int):
    """(offsets int64, pssm (total, 20) int8): ``dbsynth``'s integral
    recipe, block by block, over the given lengths."""
    n = len(lens)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    pssm = np.empty((int(offsets[-1]), N_AA), np.int8)
    for b, s in enumerate(range(0, n, dbsynth._BLOCK)):
        rng = np.random.default_rng([seed, b])
        lo, hi = int(offsets[s]), int(offsets[min(s + dbsynth._BLOCK, n)])
        m = hi - lo
        consensus = rng.choice(N_AA, m, p=BACKGROUND_FREQS)
        block = rng.normal(-2.0, 0.7, (m, N_AA)).astype(np.float32)
        block[np.arange(m), consensus] += rng.uniform(5.0, 9.0, m).astype(np.float32)
        pssm[lo:hi] = np.clip(np.round(block), -127, 127)
    return offsets, pssm


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
    lens = lengths(recipe)
    offsets, pssm = _profiles(lens, int(recipe["seed"]))
    names = np.array([f"GENOMAD.{i:06d}.XX" for i in range(n)])
    taxids = np.random.default_rng([int(recipe["seed"]), 1 << 21]).integers(0, 1000, n).astype(np.int32)
    (db_dir / "version.txt").write_text("1.9\n")
    dbsynth._save_npz(db_dir / "genomad_profiles.npz", names, lens, taxids, pssm, offsets)
    os.symlink("genomad_profiles.npz", db_dir / "genomad_mini_profiles.npz")
    ni = int(recipe["integrase_profiles"])
    i_len, i_off, i_pssm = dbsynth._profiles(
        ni, int(recipe["integrase_seed"]), int(recipe["integrase_len"][0]), int(recipe["integrase_len"][1]), None, False
    )
    dbsynth._save_npz(
        db_dir / "genomad_integrase_profiles.npz", np.array([f"INTEGRASE.{i:03d}" for i in range(ni)]),
        i_len, np.zeros(ni, np.int32), i_pssm, i_off,
    )
    dbsynth._write_metadata(db_dir, names)
    np.save(base / "consensus.npy", pssm.argmax(1).astype(np.int8))
    np.save(base / "offsets.npy", offsets)
    i_cons = i_pssm.argmax(1).astype(np.int8)
    np.savez(base / "integrase_consensus.npz", *[i_cons[i_off[i] : i_off[i + 1]] for i in range(ni)])
    ready.write_text(json.dumps(recipe))
    return MarkerDB(base, recipe), True
