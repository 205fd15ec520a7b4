"""K1's timed cases in turns between this checkout and another tree, on one
card: the way two versions of ``csrc/sw.cu`` are compared.

    python -m genomad_torch.tools.sw_turns OTHER

OTHER is a revision of this checkout's git repository or a tar file that
``git archive`` wrote (a copy of the repository without ``.git`` has only
the latter). It is unpacked into a directory of the tool's own under the
temporary directory, and every turn runs in a process of its own, in the
order P C C P: P takes OTHER's ``genomad_torch``, C this checkout's. A turn
builds its tree's K1 into that tree (OTHER's build stays in the unpacked
copy), draws ``chip_smoke.py``'s K1 cases from this checkout (the same
pairs in every turn: the annotate path's buckets of ``sw_chunk_cases`` and
the long-profile DB of ``sw_long_cases``), times them with
``sw_chunk_timing`` and ``sw_long_timing`` (no checks: ``chip_smoke.py
--only sw`` holds the kernel to its plain version) and prints one ``# sw
turn`` JSON line, with the card's name and power limit and a digest of
every case's forward result. Equal digests: the two trees' kernels agree
bit for bit on these pairs. It needs the card and a checkout, with
``chip_smoke.py`` at its root.

    python -m genomad_torch.tools.sw_turns OTHER --search

times the search's cold start instead, in the same turns: the marker search
at the real DB's 227,897 profiles, cold and steady (``chip_smoke
.cold_and_steady``), then ``chip_smoke.annotate_phase`` on a fresh
20,000-profile DB directory, each with its host seconds by stage
(``prefilter_s``, ``prestage_s``, ``staging_s``, ...), and prints one ``#
search turn`` JSON line with a digest of the hits.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import json
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path

# the checkout that holds this package (and chip_smoke.py, the cases)
ROOT = Path(__file__).resolve().parents[2]


def unpack(other: str, into: Path) -> Path:
    """``other`` (a tar file of ``git archive``, or a revision of ROOT's
    repository) unpacked in ``into``; raises unless it holds K1's wrapper."""
    if Path(other).is_file():
        tar = tarfile.open(other)
    else:
        archive = subprocess.run(["git", "-C", str(ROOT), "archive", other], check=True, capture_output=True).stdout
        tar = tarfile.open(fileobj=io.BytesIO(archive))
    with tar:
        tar.extractall(into, filter="data")
    if not (into / "genomad_torch" / "ops" / "sw.py").is_file():
        raise ValueError(f"{other}: its tree has no genomad_torch/ops/sw.py")
    return into


def turn(tree: Path, label: str, search: bool = False) -> None:
    """One turn, in a fresh process: ``tree``'s genomad_torch times ROOT's
    chip_smoke cases and prints the ``# sw turn`` line (``# search turn``
    with ``search``)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import genomad_torch
    from genomad_torch.ops import _build

    package = Path(genomad_torch.__file__).resolve().parent
    if package != (tree / "genomad_torch").resolve():
        raise RuntimeError(f"turn {label}: imported {package}, not {tree}'s genomad_torch")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _build.build(("sw",))
    if search:
        search_turn(cs, label, package)
        return
    dev = torch.device("cuda")
    chunk = cs.sw_chunk_cases(cs.bench_db(cs.SW_DB_PROFILES), np.random.default_rng(cs.SEED + 2), dev)
    long = cs.sw_long_cases(np.random.default_rng(cs.SEED + 3), dev)
    digest = hashlib.sha256()
    for t in (*chunk.values(), *long.values()):
        for x in t["fwd"]:
            digest.update(x.cpu().numpy().tobytes())
    print(f"# sw turn {label}: " + json.dumps({
        "package": str(package), "card": cs.nvidia_smi(),
        "chunk": cs.sw_chunk_timing(chunk), "long_profile_db": cs.sw_long_timing(long),
        "forward_digest": digest.hexdigest()[:16],
    }), flush=True)


def search_turn(cs, label: str, package: Path) -> None:
    """One turn of ``--search``: the real-DB search cold and steady, the
    host assembly of its buckets alone, then annotate, and the ``# search
    turn`` line."""
    import numpy as np
    import torch

    from genomad_torch import native
    from genomad_torch.ops import protein_search as ps

    if not hasattr(ps, "join_prestage"):  # a tree from before the prestage: no thread to wait for
        ps.join_prestage = lambda timeout=None: True
    # what chip_smoke's earlier phases leave ready: the C++ prefilter built (its loader raises when it
    # cannot be; a tree from before the shared loader builds it in its first search), the card's context up
    if hasattr(native, "library"):
        native.library()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    db, _, _ = cs.real_db()
    names, seqs, _ = cs.bench_queries(db, cs.N_SEARCH_QUERIES)
    runs = cs.cold_and_steady(names, seqs, db)
    # the host part of staging alone: every bucket assembled, none uploaded
    t0 = time.perf_counter()
    bound = ps._bucket_bound(db.lengths)
    for pb_i in np.unique(bound):
        ids = np.where(bound == pb_i)[0]
        for s in range(0, len(ids), ps._STAGE_CHUNK):
            ps._assemble_bucket(db, ids[s : s + ps._STAGE_CHUNK], ps._BOUNDS[pb_i])
    assemble_s = time.perf_counter() - t0
    del db
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sw_turns_annotate_") as tmp:
        annotate = cs.annotate_phase({}, Path(tmp), cs.bench_db(cs.SW_DB_PROFILES))
    annotate_stats = dict(ps.STATS)
    digest = hashlib.sha256(repr(sorted(runs["steady_hits"].items())).encode())

    def seconds(stats: dict) -> dict:
        return {k: v for k, v in stats.items() if k.endswith("_s")}

    print(f"# search turn {label}: " + json.dumps({
        "package": str(package), "card": cs.nvidia_smi(),
        "search": {
            "db_profiles": cs.REAL_DB_PROFILES, "queries": len(names),
            "cold_s": runs["cold_s"], "steady_s": runs["steady_s"],
            "cold_stages_s": seconds(runs["cold_stats"]), "steady_stages_s": seconds(runs["steady_stats"]),
            "host_assembly_s (every bucket, no upload)": assemble_s,
        },
        "annotate": {"db_profiles": cs.SW_DB_PROFILES, "wall_s": annotate["wall_s"], "marker_hits": annotate["marker_hits"],
                     "stages_s": seconds(annotate_stats)},
        "hits_digest": digest.hexdigest()[:16],
    }), flush=True)


def parse_args(argv: list[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="K1's timed cases (or the search's cold start) in turns between this checkout and OTHER.")
    parser.add_argument("other", help="a git revision of this checkout, or a tar file of `git archive`")
    parser.add_argument("--search", action="store_true", help="time the search's cold start and annotate, not K1's cases")
    parser.add_argument("--turn", metavar="LABEL", help=argparse.SUPPRESS)  # one turn of `other`, a tree
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("sw_turns: CUDA is not available; the turns time K1 on the card.", file=sys.stderr)
        return 1
    if args.turn is not None:
        turn(Path(args.other), args.turn, args.search)
        return 0
    with tempfile.TemporaryDirectory(prefix="sw_turns_") as tmp:
        trees = {"P": unpack(args.other, Path(tmp)), "C": ROOT}
        for letter in "PCCP":
            # by path, not -m: the turn's process imports no genomad_torch but its tree's
            cmd = [sys.executable, str(Path(__file__).resolve()), str(trees[letter]), "--turn", letter]
            if args.search:
                cmd.append("--search")
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
