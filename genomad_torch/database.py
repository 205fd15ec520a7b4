"""geNomad database directory accessor.

Parses the downloaded ``genomad_db/`` directory (reference analog:
genomad/database.py:8-135): marker metadata (specificity classes, SPM values,
hallmark/USCG/CONJscan/AMR annotations), the ICTV taxdump, and the protein
profile databases consumed by the search engine
(genomad_torch.ops.protein_search).

A copy of ``genomad_tpu/database.py``.
"""

from __future__ import annotations

from pathlib import Path

from genomad_torch import utils

# see Database.get_profile_db — (path, mtime) -> loaded ProfileDB
_PROFILE_DB_CACHE: dict = {}


class Database:
    def __init__(self, database_directory: Path) -> None:
        self._directory = Path(database_directory)
        version_file = self._directory / "version.txt"
        if version_file.exists():
            self._version = float(version_file.read_text().strip())
        else:
            self._version = 0.0
        self._marker_features = None
        self._marker_annotation = None
        self._taxdb = None

    @property
    def directory(self) -> Path:
        return self._directory

    @property
    def version(self) -> float:
        return self._version

    @property
    def mmseqs2_db(self) -> Path:
        return self._directory / "genomad_db"

    @property
    def mmseqs2_minimal_db(self) -> Path:
        return self._directory / "genomad_mini_db"

    @property
    def mmseqs2_integrase_db(self) -> Path:
        return self._directory / "genomad_integrase_db"

    @property
    def nodes_dmp(self) -> Path:
        return self._directory / "nodes.dmp"

    @property
    def names_dmp(self) -> Path:
        return self._directory / "names.dmp"

    @property
    def metadata_file(self) -> Path:
        return self._directory / "genomad_marker_metadata.tsv"

    # Native packed-profile databases (genomad_torch.ops.profiledb format).
    # These replace the MMseqs2 profile DBs consumed by the reference; the
    # converter in tools/build_profile_db.py produces them.

    @property
    def profile_db_file(self) -> Path:
        return self._directory / "genomad_profiles.npz"

    @property
    def minimal_profile_db_file(self) -> Path:
        return self._directory / "genomad_mini_profiles.npz"

    @property
    def integrase_profile_db_file(self) -> Path:
        return self._directory / "genomad_integrase_profiles.npz"

    def get_profile_db(self, use_minimal_db: bool = False, use_integrase_db: bool = False):
        """Load the packed profile DB (reference analog: the MMseqs2 DB
        selection in genomad/mmseqs2.py:23-31)."""
        from genomad_torch.ops.profiledb import ProfileDB

        if use_integrase_db:
            path, mmseqs_db = self.integrase_profile_db_file, self.mmseqs2_integrase_db
        elif use_minimal_db:
            path, mmseqs_db = self.minimal_profile_db_file, self.mmseqs2_minimal_db
        else:
            path, mmseqs_db = self.profile_db_file, self.mmseqs2_db
        if not path.exists():
            # Manually-extracted DB directories (e.g. from the Zenodo
            # mirror) carry only the MMseqs2 profile files; pack on first
            # use so the directory is turnkey either way.
            if Path(f"{mmseqs_db}.index").exists():
                from genomad_torch.ops import mmseqs_io

                db = mmseqs_io.convert_mmseqs_profile_db(mmseqs_db)
                try:
                    db.save(path)
                except OSError:  # read-only DB directory: use in-memory
                    pass
                return db
            raise FileNotFoundError(
                f"profile database {path} not found and no MMseqs2 profile "
                f"files to pack it from — run download-database, or build "
                "it with tools/build_profile_db.py"
            )
        # In-process cache keyed by (path, mtime): a service classifying
        # many inputs per process must not reload the multi-GB PSSM — or
        # lose the ProfileDB-attached device staging (HBM buckets), k-mer
        # index, and int8 copy — on every module invocation.
        key = (str(path), path.stat().st_mtime_ns)
        db = _PROFILE_DB_CACHE.get(key)
        if db is None:
            while len(_PROFILE_DB_CACHE) >= 4:
                _PROFILE_DB_CACHE.pop(next(iter(_PROFILE_DB_CACHE)))
            db = ProfileDB.load(path)
            _PROFILE_DB_CACHE[key] = db
        return db

    def get_marker_annotation(self) -> dict:
        """marker -> (uscg, plasmid_hallmark, virus_hallmark, conjscan, amr,
        accessions, description) — reference: database.py:42-79.

        Metadata columns (0-indexed): 0 marker, ..., -9 uscg,
        -8 plasmid_hallmark, -7 virus_hallmark, -6 conjscan, -5 amr,
        -4 accession, -3 description, -2, -1.
        """
        if self._marker_annotation is None:
            annotation = {}
            for line in utils.read_file(self.metadata_file, skip_header=True):
                fields = line.strip("\n").split("\t")
                marker = fields[0]
                uscg, plasmid_hallmark, virus_hallmark, conjscan, amr, accession, description = fields[-9:-2]
                annotation[marker] = (
                    int(uscg != "NA"),
                    int(plasmid_hallmark),
                    int(virus_hallmark),
                    conjscan,
                    amr,
                    accession,
                    description,
                )
            self._marker_annotation = annotation
        return self._marker_annotation

    def get_marker_features(self) -> dict:
        """marker -> (specificity_class, spm_c, spm_p, spm_v, gv_marker,
        uscg, plasmid_hallmark, virus_hallmark) — reference: database.py:81-127.

        Metadata columns: 0 marker, 2 specificity_class, 4 spm_c, 5 spm_p,
        6 spm_v, 7 gv_marker, -9 uscg, -8 plasmid_hallmark, -7 virus_hallmark.
        """
        if self._marker_features is None:
            features = {}
            for line in utils.read_file(self.metadata_file, skip_header=True):
                fields = line.strip("\n").split("\t")
                features[fields[0]] = (
                    fields[2],
                    float(fields[4]),
                    float(fields[5]),
                    float(fields[6]),
                    int(fields[7]),
                    int(fields[-9] != "NA"),
                    int(fields[-8]),
                    int(fields[-7]),
                )
            self._marker_features = features
        return self._marker_features

    def get_taxdb(self):
        """ICTV taxonomy database (reference: database.py:129-135, taxopy)."""
        if self._taxdb is None:
            from genomad_torch import taxonomy

            self._taxdb = taxonomy.TaxDb(self.nodes_dmp, self.names_dmp)
        return self._taxdb
