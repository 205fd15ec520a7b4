"""Runtime utilities: console/logging, file IO, the resume protocol, the
window cache's archive writer and math primitives.

Copied from ``genomad_tpu/utils.py`` (all but ``Console.status``, which no
module of the port calls); behaviour and file formats are unchanged. Added:
``savez_compressed_threaded``, ``np.savez_compressed``'s zip with each
member's deflate split over threads. Reference = apcamargo/genomad
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
import struct
import sys
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
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
# Compressed array archives, deflated on every host core
# ---------------------------------------------------------------------------

DEFLATE_LEVEL = 6  # zlib's default: the level np.savez_compressed deflates at
CHUNK_BYTES = 256 * 1024  # a member is split into chunks of at least this many bytes
_ZIP64_LIMIT = (1 << 31) - 1  # zipfile.ZIP64_LIMIT: larger sizes and offsets go in zip64 fields
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_END64_LOCATOR = struct.Struct("<4sLQL")


def _npy_member(array) -> tuple[bytes, memoryview]:
    """The array's ``.npy`` bytes as ``np.lib.format.write_array`` writes
    them: the header, and a byte view of the C-ordered data (no copy)."""
    array = np.asarray(array, order="C")
    if array.dtype.hasobject:
        raise ValueError("object arrays would need pickles; they are not written")
    header = io.BytesIO()
    np.lib.format.write_array_header_1_0(header, np.lib.format.header_data_from_array_1_0(array))
    return header.getvalue(), memoryview(array.reshape(-1).view(np.uint8))


def _deflate(pieces: list, last: bool) -> bytes:
    """One chunk of a raw deflate stream: a sync flush ends every chunk but
    the last, so the chunks concatenate into one stream (as pigz builds it)."""
    z = zlib.compressobj(DEFLATE_LEVEL, zlib.DEFLATED, -15)
    out = [z.compress(p) for p in pieces]
    out.append(z.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _deflate_member(buffers: list, threads: int, chunk_bytes: int) -> tuple[int, list[bytes]]:
    """CRC-32 and deflate chunks of the concatenated ``buffers``: contiguous
    chunks of max(chunk_bytes, ceil(size / threads)) bytes, the last shorter,
    so k = clamp(ceil(size / chunk_bytes), 1, threads) wherever a member
    exceeds threads^2 bytes; deflated on k threads (zlib releases the
    interpreter lock while it deflates)."""
    size = sum(len(b) for b in buffers)
    step = max(chunk_bytes, -(-size // threads))
    bounds = [*range(0, size, step), size]
    k = len(bounds) - 1
    chunks = []
    for lo, hi in zip(bounds, bounds[1:]):
        pieces, start = [], 0
        for b in buffers:
            a, z = max(lo, start), min(hi, start + len(b))
            if a < z:
                pieces.append(b[a - start : z - start])
            start += len(b)
        chunks.append(pieces)
    with ThreadPoolExecutor(max_workers=k, thread_name_prefix="genomad-deflate") as pool:
        futures = [pool.submit(_deflate, pieces, i == k - 1) for i, pieces in enumerate(chunks)]
        crc = 0
        for b in buffers:  # while the pool deflates
            crc = zlib.crc32(b, crc)
        return crc, [f.result() for f in futures]


def savez_compressed_threaded(path, threads=None, *, chunk_bytes=CHUNK_BYTES, **arrays) -> dict[str, int]:
    """Writes ``arrays`` to ``path`` as ``np.savez_compressed`` does: one zip
    of ``<key>.npy`` members in the order given, deflated at level 6, that
    ``np.load`` reads (no pickles). Each member's deflate stream is built from
    chunks deflated in parallel on up to ``threads`` threads (``None``: every
    available core), each at least ``chunk_bytes``: a small member stays one
    stream, and each further chunk restarts deflate's 32 KiB window, so the
    file grows by a fraction of a percent. The file is written under a
    temporary name beside ``path`` and renamed into place. Returns each key's
    chunk count."""
    path = Path(path)
    threads = max(1, get_n_available_cpus() if threads is None else threads)
    t = time.localtime()
    dostime = t.tm_hour << 11 | t.tm_min << 5 | t.tm_sec // 2
    dosdate = (t.tm_year - 1980) << 9 | t.tm_mon << 5 | t.tm_mday
    # a name of this process and thread; open() gives the umask's permissions
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    chunk_counts, central = {}, []
    try:
        with open(tmp, "wb") as f:
            for key, array in arrays.items():
                name = f"{key}.npy"
                flags = 0 if name.isascii() else 0x800  # UTF-8 name
                name = name.encode()
                header, data = _npy_member(array)
                crc, deflated = _deflate_member([header, data], threads, chunk_bytes)
                usize, csize, offset = len(header) + len(data), sum(map(len, deflated)), f.tell()
                # local header: the sizes in its zip64 field, as numpy's force_zip64 members
                f.write(_LOCAL.pack(
                    b"PK\x03\x04", 45, 0, flags, zipfile.ZIP_DEFLATED, dostime, dosdate,
                    crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name), 20,
                ))
                f.write(name + struct.pack("<2H2Q", 1, 16, usize, csize))
                f.writelines(deflated)
                chunk_counts[key] = len(deflated)
                extra = []
                if usize > _ZIP64_LIMIT or csize > _ZIP64_LIMIT:
                    extra += [usize, csize]
                    usize = csize = 0xFFFFFFFF
                if offset > _ZIP64_LIMIT:
                    extra.append(offset)
                    offset = 0xFFFFFFFF
                extra = struct.pack(f"<2H{len(extra)}Q", 1, 8 * len(extra), *extra) if extra else b""
                central.append(_CENTRAL.pack(
                    b"PK\x01\x02", 45, 3, 45, 0, flags, zipfile.ZIP_DEFLATED, dostime, dosdate,
                    crc, csize, usize, len(name), len(extra), 0, 0, 0, 0o600 << 16, offset,
                ) + name + extra)
            cd_offset = f.tell()
            f.writelines(central)
            cd_size, n = f.tell() - cd_offset, len(central)
            if n > 0xFFFF or cd_offset > _ZIP64_LIMIT or cd_size > _ZIP64_LIMIT:
                end64 = f.tell()
                f.write(_END64.pack(b"PK\x06\x06", 44, 45, 45, 0, 0, n, n, cd_size, cd_offset))
                f.write(_END64_LOCATOR.pack(b"PK\x06\x07", 0, end64, 1))
            n = min(n, 0xFFFF)
            cd_size, cd_offset = min(cd_size, 0xFFFFFFFF), min(cd_offset, 0xFFFFFFFF)
            f.write(_END.pack(b"PK\x05\x06", 0, 0, n, n, cd_size, cd_offset, 0))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return chunk_counts


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
