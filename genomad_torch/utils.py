"""Runtime utilities: console/logging, file IO, the resume protocol and math
primitives.

Copied from ``genomad_tpu/utils.py`` (all but ``Console.status``, which no
module of the port calls); behaviour and file formats are unchanged. Reference = apcamargo/genomad
v1.12.0:
  - compression sniffing / transparent open: genomad/utils.py:126-171
  - md5 + execution-info resume protocol:    genomad/utils.py:216-297
  - math primitives (logistic / softmax / entropy / specificity / RLE):
                                             genomad/utils.py:328-384
"""

from __future__ import annotations

import bz2
import gzip
import hashlib
import io
import json
import lzma
import os
import re
import shutil
import sys
from contextlib import contextmanager
from datetime import datetime, timezone
from enum import Enum, auto
from pathlib import Path
from typing import Iterator

import numpy as np

from genomad_torch import trace


class Compression(Enum):
    bzip2 = auto()
    gzip = auto()
    xz = auto()
    zstd = auto()
    uncompressed = auto()


def is_compressed(filepath: Path) -> Compression:
    """Sniff compression from magic bytes (reference: genomad/utils.py:126-152)."""
    with open(filepath, "rb") as fin:
        signature = fin.read(8)
    if signature[:2] == b"\x1f\x8b":
        return Compression.gzip
    if signature[:3] == b"\x42\x5a\x68":
        return Compression.bzip2
    if signature[:7] == b"\xfd\x37\x7a\x58\x5a\x00\x00":
        return Compression.xz
    if signature[:4] == b"\x28\xb5\x2f\xfd":
        return Compression.zstd
    return Compression.uncompressed


@contextmanager
def open_file(filepath):
    """Open a possibly-compressed text file (reference: genomad/utils.py:155-171)."""
    compression = is_compressed(Path(filepath))
    if compression is Compression.gzip:
        fin = gzip.open(filepath, "rt")
    elif compression is Compression.bzip2:
        fin = bz2.open(filepath, "rt")
    elif compression is Compression.xz:
        fin = lzma.open(filepath, "rt")
    elif compression is Compression.zstd:
        try:
            import zstandard

            fin = io.TextIOWrapper(zstandard.open(filepath, "rb"))
        except ImportError:  # pragma: no cover
            raise RuntimeError("zstd-compressed input requires the zstandard package")
    else:
        fin = open(filepath, "r")
    try:
        yield fin
    finally:
        fin.close()


def read_file(filepath: Path, skip_header: bool = False) -> Iterator[str]:
    with open_file(filepath) as fin:
        if skip_header:
            next(fin, None)
        yield from fin


def natsort(iterable):
    """Natural-order sort (reference: genomad/utils.py:190-196)."""
    return sorted(
        iterable,
        key=lambda s: [
            int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))
        ],
    )


def check_executables(executables: list[str]) -> list[str]:
    """The names in ``executables`` that are not on the PATH."""
    return [e for e in executables if not shutil.which(e)]


def get_md5(filepath, size=io.DEFAULT_BUFFER_SIZE) -> str:
    """The file's md5 (span ``md5``; counter ``md5.bytes``)."""
    m = hashlib.md5()
    n = 0
    with trace.span("md5"), open(filepath, "rb") as fin:
        while chunk := fin.read(size):
            m.update(chunk)
            n += len(chunk)
    trace.count("md5.bytes", n)
    return m.hexdigest()


def get_n_available_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


# ---------------------------------------------------------------------------
# Console
# ---------------------------------------------------------------------------


class Console:
    """Console that mirrors output to a per-module log file.

    Timestamped log lines to stdout (unless quiet) and appended to
    ``output_file``; warnings/errors highlighted; errors also go to stderr.
    """

    def __init__(self, output_file=None, verbose: bool = True):
        self.output_file = Path(output_file) if output_file else None
        self.verbose = verbose
        if self.output_file is not None and self.output_file.exists():
            self.output_file.unlink()
        try:
            from rich.console import Console as RichConsole

            self._rich = RichConsole(highlight=False) if verbose else None
            self._rich_err = RichConsole(stderr=True, style="red", highlight=False)
        except ImportError:  # pragma: no cover
            self._rich = None
            self._rich_err = None

    def _timestamp(self) -> str:
        return datetime.now().strftime("[%X]")

    def _write_file(self, message: str) -> None:
        if self.output_file is None:
            return
        self.output_file.parent.mkdir(parents=True, exist_ok=True)
        with open(self.output_file, "a") as fout:
            plain = re.sub(r"\[/?[a-z#][^\]]*\]", "", message)
            fout.write(f"{self._timestamp()} {plain}\n")

    def print(self, message: str = "", **kwargs) -> None:
        if self.verbose and self._rich is not None:
            self._rich.print(message, **kwargs)
        elif self.verbose:
            print(message)
        self._write_file(str(message))

    def log(self, message: str, style: str | None = None) -> None:
        if self.verbose and self._rich is not None:
            self._rich.print(f"{self._timestamp()} {message}", style=style)
        elif self.verbose:
            print(f"{self._timestamp()} {message}")
        self._write_file(str(message))

    def warning(self, message: str) -> None:
        self.log(message, style="#FFA500")

    def error(self, message: str) -> None:
        if self._rich_err is not None:
            self._rich_err.print(f"{self._timestamp()} {message}")
        else:
            print(message, file=sys.stderr)
        self._write_file(str(message))

    @contextmanager
    def timer(self, stage: str, span: str | None = None):
        """Per-stage wall-clock timing, logged when the stage ends; the
        stage is also a span (``genomad_torch.trace``) named ``span``, or
        the stage's name."""
        import time

        with trace.span(span or stage):
            start = time.perf_counter()
            yield
            self.log(f"[{stage}] completed in {time.perf_counter() - start:.2f}s")


def display_header(console, module_name, module_description, output_dir, output_files, output_descriptions):
    """Print the module banner (reference: genomad/utils.py:300-325)."""
    from genomad_torch import __version__

    console.print(
        f"Executing [cyan]genomad-torch {module_name}[/cyan] (v{__version__}). "
        + module_description
    )
    console.print(f"Outputs ({output_dir}):")
    for f, d in zip(output_files, output_descriptions):
        console.print(f"  {Path(f).name} ({d})")


# ---------------------------------------------------------------------------
# Execution info / resume
# ---------------------------------------------------------------------------


def write_execution_info(module_name: str, input_file: Path, parameters: dict, output_file: Path) -> None:
    """Persist the run manifest used for resume (reference: genomad/utils.py:238-254)."""
    payload = {
        "module": module_name,
        "input": Path(input_file).name,
        "input_md5": get_md5(input_file),
        "start_time": datetime.now(timezone.utc).astimezone().isoformat(),
        "parameters": parameters,
    }
    Path(output_file).parent.mkdir(parents=True, exist_ok=True)
    with open(output_file, "w") as fout:
        fout.write(json.dumps(payload, indent=4) + "\n")


def get_execution_info(input_file: Path):
    with open(input_file) as fin:
        info = json.load(fin)
    return info["input_md5"], info["module"], info["parameters"]


def compare_executions(input_file: Path, parameters: dict, execution_info_file: Path, only_md5: bool = False) -> bool:
    """True if a previous run used the same input (and parameters) —
    reference: genomad/utils.py:266-277."""
    input_md5 = get_md5(input_file)
    previous_md5, _, previous_parameters = get_execution_info(execution_info_file)
    if only_md5:
        return input_md5 == previous_md5
    return parameters == previous_parameters and input_md5 == previous_md5


def check_provirus_execution(prefix: str, input_file: Path, output_dir: Path) -> bool:
    """True if find-proviruses ran on the same input and found >=1 provirus
    (reference: genomad/utils.py:280-297)."""
    from genomad_torch.paths import GenomadOutputs

    outputs = GenomadOutputs(prefix, Path(output_dir))
    if not outputs.find_proviruses_execution_info.exists():
        return False
    if get_md5(input_file) != get_execution_info(outputs.find_proviruses_execution_info)[0]:
        return False
    required = [
        outputs.find_proviruses_output,
        outputs.find_proviruses_nucleotide_output,
        outputs.find_proviruses_proteins_output,
        outputs.find_proviruses_genes_output,
    ]
    if not all(p.exists() for p in required):
        return False
    n_proviruses = sum(1 for _ in read_file(outputs.find_proviruses_output, skip_header=True))
    return n_proviruses > 0


def output_prefix(input_path: Path) -> str:
    """Derive the run prefix from the input filename, stripping a compression
    suffix (reference convention, e.g. genomad/modules/annotate.py:69-71)."""
    input_path = Path(input_path)
    prefix = input_path.stem
    if is_compressed(input_path) != Compression.uncompressed:
        prefix = prefix.rsplit(".", 1)[0]
    return prefix


# ---------------------------------------------------------------------------
# Math primitives (bit-parity with reference genomad/utils.py:328-384)
# ---------------------------------------------------------------------------


def logistic(x, temperature: float = 1.0):
    return 1 / (1 + np.exp(-np.asarray(x, dtype=np.float64) / temperature))


def softmax(x, temperature: float = 1.0, axis: int = 1):
    x = np.asarray(x) / temperature
    x_max = np.max(x, axis=axis, keepdims=True)
    e_x = np.exp(x - x_max)
    return e_x / np.sum(e_x, axis=axis, keepdims=True)


def entropy(x):
    x = np.asarray(x)
    n = len(x)
    if not np.any(x):
        return np.log2(n)
    p = x / np.sum(x)
    p = p[p != 0]
    return -1 * np.dot(p, np.log2(p))


def specificity(x):
    """Specificity measure (SPM) of a distribution (reference: utils.py:349-357)."""
    x = np.asarray(x)
    if not np.any(x):
        return 0.0
    n = len(x)
    if n == 1:
        return 0.0
    return (np.log2(n) - entropy(x)) / np.log2(n)


def rle_encode(array):
    """Run-length encode -> (counts, values) (reference: utils.py:360-377)."""
    counts, values = [], []
    i, n = 0, len(array)
    while i < n:
        j = i
        while j + 1 < n and array[j + 1] == array[i]:
            j += 1
        counts.append(j - i + 1)
        values.append(array[i])
        i = j + 1
    return counts, values


def rle_decode(counts, values):
    decoded = []
    for c, v in zip(counts, values):
        decoded += [v] * c
    return decoded
