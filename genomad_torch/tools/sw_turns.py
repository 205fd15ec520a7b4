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


def turn(tree: Path, label: str) -> None:
    """One turn, in a fresh process: ``tree``'s genomad_torch times ROOT's
    chip_smoke cases and prints the ``# sw turn`` line."""
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


def parse_args(argv: list[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="K1's timed cases in turns between this checkout and OTHER.")
    parser.add_argument("other", help="a git revision of this checkout, or a tar file of `git archive`")
    parser.add_argument("--turn", metavar="LABEL", help=argparse.SUPPRESS)  # one turn of `other`, a tree
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("sw_turns: CUDA is not available; the turns time K1 on the card.", file=sys.stderr)
        return 1
    if args.turn is not None:
        turn(Path(args.other), args.turn)
        return 0
    with tempfile.TemporaryDirectory(prefix="sw_turns_") as tmp:
        trees = {"P": unpack(args.other, Path(tmp)), "C": ROOT}
        for letter in "PCCP":
            # by path, not -m: the turn's process imports no genomad_torch but its tree's
            cmd = [sys.executable, str(Path(__file__).resolve()), str(trees[letter]), "--turn", letter]
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
