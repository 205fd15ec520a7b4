"""The marker search at protein lengths, on the CPU: a DB with a tail of
profiles above 1,024 columns (the buckets K1's long body aligns on the
card) and one above 4,096 (the 32768 bucket), queries planted from them,
one above 1,024 residues. Every reported hit is held to the benchmark's
plain reference (``benchmark/reference/sw.py``, float64), which imports
nothing of the port; and the counters of the long body's pairs and cells
count what the search aligned."""

import numpy as np
import pytest
import torch

from benchmark.reference import sw as ref
from genomad_torch import trace
from genomad_torch.ops import protein_search as tps
from genomad_torch.ops.profiledb import ALPHABET, N_AA, ProfileDB
from genomad_torch.ops.sw import _CHUNK_MAX_LP

torch.set_num_threads(2)

EVALUE = 1e-3
MIN_COV = np.float32(0.2)
BORDER = 1e-4  # an E-value this close to the gate is decided by f32 rounding


def _seq(res):
    return "".join(ALPHABET[r] for r in res)


def _mutated(rng, residues, rate):
    prot = np.array(residues, copy=True)
    pos = rng.choice(len(prot), int(len(prot) * rate), replace=False)
    prot[pos] = rng.integers(0, N_AA, len(pos))
    return prot


def _long_tail_db():
    """300 seeded integral profiles: 286 of 60-400 columns, 13 of
    1,025-1,500 and one of 4,200."""
    short = ProfileDB.synthetic(seed=61, n_profiles=286, min_len=60, max_len=400, integral=True)
    long = ProfileDB.synthetic(seed=62, n_profiles=13, min_len=1025, max_len=1500, integral=True)
    longest = ProfileDB.synthetic(seed=63, n_profiles=1, min_len=4200, max_len=4200, integral=True)
    pssms = [short.profile(i) for i in range(286)] + [long.profile(i) for i in range(13)] + [longest.profile(0)]
    return ProfileDB.from_profiles([f"p{i}" for i in range(len(pssms))], pssms)


def _planted_queries(db):
    """(names, sequences, planted profile of each): mutated consensus of
    ten short profiles, the whole of the shortest long profile (above 1,024
    residues), windows of a long profile (600 residues) and of the
    4,200-column one (1,000) that end past column 1,024, and noise."""
    rng = np.random.default_rng(64)
    names, seqs, want = [], [], {}

    def plant(name, residues, profile):
        names.append(name)
        seqs.append(_seq(_mutated(rng, residues, 0.1)))
        want[name] = f"p{profile}"

    for k in rng.choice(286, 10, replace=False):
        plant(f"short_{k}", db.profile(int(k)).argmax(1), int(k))
    whole = 286 + int(np.argmin(db.lengths[286:299]))
    plant("whole_long", db.profile(whole).argmax(1), whole)
    for k, n in ((290, 600), (299, 1000)):  # the coverage gate asks for a fifth of the profile
        cons = db.profile(k).argmax(1)
        start = int(rng.integers(1025 - n, len(cons) - n + 1))
        plant(f"window_{k}", cons[start : start + n], k)
    for k in range(3):
        names.append(f"noise_{k}")
        seqs.append(_seq(rng.integers(0, N_AA, 250)))
    return names, seqs, want


def _reference_hits(names, seqs, hits, db):
    """(gene, bitscore, E-value as reported, passes the gates or lies at
    the E-value gate) of each reported hit by the reference, one alignment
    per hit: their lengths differ too much to pad into one block."""
    n_gate = sum(len(s) for s in seqs)
    db_positions = int(db.lengths.sum())
    index = {str(n): i for i, n in enumerate(db.names)}
    out = {}
    for g, (target, _, _, _) in hits.items():
        q = seqs[names.index(g)]
        p = db.profile(index[target]).astype(np.float32)
        score, _, end_j, start_j = ref.align([ref.encode(q)], [p])
        bits = ref.int_bitscore(score)[0]
        ev = ref.gate_evalue(score, [len(p)], n_gate)[0]
        cov = np.float32(end_j[0] - start_j[0] + 1) / np.float32(len(p))
        passes = (ev <= EVALUE and cov >= MIN_COV) or abs(np.log(ev / EVALUE)) <= BORDER
        out[g] = (int(bits), float(ref.reported_evalue(bits, len(q), db_positions)), bool(passes))
    return out


def test_long_tail_search_equals_the_plain_reference():
    db = _long_tail_db()
    names, seqs, want = _planted_queries(db)
    assert max(len(s) for s in seqs) > _CHUNK_MAX_LP and db.lengths.max() > 4096
    tps.STATS.clear()
    hits = tps.search(names, seqs, db, device="cpu", evalue_threshold=EVALUE)
    assert {q: hits[q][0] for q in want if q in hits} == want  # every planted query finds its profile
    expected = _reference_hits(names, seqs, hits, db)
    for g, (target, ev, bits, _) in hits.items():
        assert (bits, ev, True) == expected[g], (g, target)
    # the long buckets were aligned, forward and reverse
    assert 0 < tps.STATS["pairs_forward_long"] < tps.STATS["pairs_forward"]
    assert 0 < tps.STATS["cells_forward_long"] < tps.STATS["cells_forward"]
    assert 0 < tps.STATS["cells_reverse_long"] < tps.STATS["cells_reverse"]


@pytest.mark.parametrize("long_lengths", [[], [1024], [1025, 1300], [4097]], ids=["none", "at_1024", "above", "32768_bucket"])
def test_long_body_counters_count_the_pairs_of_long_buckets(long_lengths):
    """All pairs (a DB of 256 profiles or fewer): the long counters hold
    exactly the pairs and cells of the profiles above 1,024 columns."""
    rng = np.random.default_rng(65)
    lengths = [int(x) for x in rng.integers(40, 120, 30)] + long_lengths
    pssms = [np.where(np.arange(N_AA)[None, :] == rng.integers(0, N_AA, (L, 1)), 6.0, -2.0).astype(np.float32) for L in lengths]
    db = ProfileDB.from_profiles([f"p{i}" for i in range(len(pssms))], pssms)
    seqs = [_seq(db.profile(i).argmax(1)[:50]) for i in (0, 1)] + [_seq(rng.integers(0, N_AA, 60))]
    q_len = np.array([len(s) for s in seqs], np.float64)
    trace.COUNTERS.clear()
    tps.search([f"q{i}" for i in range(3)], seqs, db, device="cpu")
    long = np.array(lengths) > _CHUNK_MAX_LP
    c = trace.COUNTERS
    assert c["pairs_forward"] == 3 * len(lengths)
    assert c["pairs_forward_long"] == 3 * long.sum()
    assert c["cells_forward_long"] == q_len.sum() * np.array(lengths)[long].sum()
    assert c["cells_reverse_long"] <= c["cells_reverse"]
    if not long.any():
        assert c["cells_forward_long"] == c["cells_reverse_long"] == 0
