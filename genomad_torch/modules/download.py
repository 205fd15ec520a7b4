"""download-database module: fetch, verify, extract, and pack the geNomad DB.

Contract parity with genomad/modules/download.py:19-105, plus turnkey
preparation for the search engine: resolves the DB version compatible with
this release from ``releases.txt``, streams ``genomad_db_v{V}.tar.gz``
from the distribution endpoint with a progress bar, verifies the
tarball's md5 when the endpoint publishes one, extracts it into
``<destination>/genomad_db``, and converts the MMseqs2 profile DBs into
the packed native format consumed by the search engine — after this
command the database directory is ready to use, no extra tooling step
(the reference is equally turnkey because its engine reads the MMseqs2
format directly).

The endpoint can be overridden with ``GENOMAD_TORCH_DB_URL`` (any URL
scheme ``urllib`` supports, including ``file://`` — used by the tests to
exercise the full flow hermetically).

A copy of ``genomad_tpu/modules/download.py``.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import urllib.request
from pathlib import Path

from genomad_torch import utils
from genomad_torch.ops import mmseqs_io

DEFAULT_BASE_URL = "https://portal.nersc.gov/genomad/__data__/"
# geNomad database major.minor version compatible with this pipeline's
# metadata parsers (reference: download.py:29-47 matches package version).
COMPATIBLE_PACKAGE_VERSION = "1.9"


class DatabaseDownloader:
    def __init__(self, destination: Path, keep: bool = False, verbose: bool = True):
        self.destination = Path(destination)
        self.keep = keep
        self.console = utils.Console(verbose=verbose)
        self.base_url = os.environ.get("GENOMAD_TORCH_DB_URL", DEFAULT_BASE_URL)
        if not self.base_url.endswith("/"):
            self.base_url += "/"

    def resolve_version(self) -> str:
        """Pick the DB version matching this package from releases.txt.

        The file is a header line followed by ``db_version<TAB>pkg_version``
        rows (reference download.py:29-47); plain whitespace token lists
        are accepted as a fallback.
        """
        try:
            with urllib.request.urlopen(self.base_url + "releases.txt", timeout=30) as r:
                lines = r.read().decode().strip().split("\n")
        except OSError as e:
            raise RuntimeError(
                f"could not reach {self.base_url} ({e}); download the database "
                "manually (Zenodo mirror) and extract it to "
                f"{self.destination / 'genomad_db'}, then it will be packed "
                "automatically on first use"
            ) from e
        selected = None
        for line in lines[1:]:
            fields = line.strip().split("\t")
            if len(fields) == 2 and fields[1] == COMPATIBLE_PACKAGE_VERSION:
                selected = fields[0]
        if selected is None:  # fallback: whitespace token list of versions
            tokens = " ".join(lines).split()
            matching = [v for v in tokens if v.startswith(COMPATIBLE_PACKAGE_VERSION)]
            selected = sorted(matching)[-1] if matching else None
        if selected is None:
            raise RuntimeError(
                f"no database release compatible with v{COMPATIBLE_PACKAGE_VERSION} "
                f"found in {self.base_url}releases.txt"
            )
        return selected

    def download(self) -> Path:
        version = self.resolve_version()
        self.destination.mkdir(parents=True, exist_ok=True)
        tarball = self.destination / f"genomad_db_v{version}.tar.gz"
        url = self.base_url + tarball.name
        self.console.log(f"Requesting {url}.")
        response = urllib.request.urlopen(url)
        total = int(response.info().get("Content-length") or 0)
        digest = hashlib.md5()
        try:
            from rich.progress import (
                BarColumn,
                DownloadColumn,
                Progress,
                TextColumn,
                TimeRemainingColumn,
                TransferSpeedColumn,
            )

            progress = Progress(
                TextColumn("{task.fields[filename]}", justify="right", style="green"),
                BarColumn(bar_width=None),
                "[progress.percentage]{task.percentage:>3.1f}%",
                "|",
                DownloadColumn(),
                "|",
                TransferSpeedColumn(),
                "|",
                TimeRemainingColumn(elapsed_when_finished=True),
                transient=True,
                disable=not self.console.verbose,
            )
        except ImportError:  # pragma: no cover - rich is a hard dep of the CLI
            progress = None
        with open(tarball, "wb") as fout:
            if progress is not None:
                with progress:
                    task = progress.add_task("download", filename=tarball.name, total=total or None)
                    while chunk := response.read(1 << 20):
                        fout.write(chunk)
                        digest.update(chunk)
                        progress.update(task, advance=len(chunk))
            else:  # pragma: no cover
                while chunk := response.read(1 << 20):
                    fout.write(chunk)
                    digest.update(chunk)
        self._verify_md5(url, tarball, digest.hexdigest())
        return tarball

    def _verify_md5(self, url: str, tarball: Path, got: str) -> None:
        """Check the tarball against ``<url>.md5`` when the endpoint
        publishes one; missing checksum files are not an error (the
        reference performs no verification at all)."""
        try:
            with urllib.request.urlopen(url + ".md5", timeout=15) as r:
                expected = r.read().decode().split()[0].strip().lower()
        except OSError:
            self.console.log("No published checksum found; skipping verification.")
            return
        if expected != got:
            tarball.unlink(missing_ok=True)
            raise RuntimeError(
                f"md5 mismatch for {tarball.name}: expected {expected}, got {got}"
            )
        self.console.log("Checksum verified.")

    def extract(self, tarball: Path) -> None:
        self.console.log(f"Extracting {tarball.name}.")
        with tarfile.open(tarball) as tar:
            tar.extractall(self.destination, filter="data")
        if not self.keep:
            tarball.unlink()


def main(destination, keep=False, verbose=True):
    downloader = DatabaseDownloader(destination, keep, verbose)
    tarball = downloader.download()
    downloader.extract(tarball)
    db_dir = downloader.destination / "genomad_db"
    packed = mmseqs_io.build_packed_dbs(db_dir, console=downloader.console)
    if packed:
        downloader.console.log(
            f"geNomad database is ready to be used ({len(packed)} packed "
            "profile databases built).",
            style="yellow",
        )
    else:
        downloader.console.warning(
            "No MMseqs2 profile databases were found to pack; the search "
            "engine will not run until genomad_profiles.npz exists in "
            f"{db_dir}."
        )
