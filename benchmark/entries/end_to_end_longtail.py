"""The ``end-to-end`` command as ``end_to_end`` runs it, against a DB whose
profile lengths follow a log-normal law (``benchmark.dbsynth_longtail``):
its tail above 1,024 columns lies in the profile buckets that K1's long body
aligns, and the planted marker genes, copies of their profiles' consensus,
reach the long query buckets too.

Spans and check as ``end_to_end``. The check also counts in ``judged`` the
reported hits to profiles above 1,024 columns that it compared
(``long_hits``).
"""

from __future__ import annotations

from pathlib import Path

from benchmark import dbsynth_longtail
from benchmark.entries import end_to_end
from benchmark.entries.common import Base

LONG_COLUMNS = 1024  # wider profile buckets take K1's long body


class Entry(end_to_end.Entry):
    def __init__(self, name: str, config: dict, device, cache: Path):
        Base.__init__(self, config, device)
        self.db, _ = dbsynth_longtail.ensure_db(name, config["db"], cache)
        self.sw_device = "cuda" if self.on_card else "cpu"

    def _judge(self, job, proteins, hits, index, pssm, db_positions) -> tuple[int, int]:
        long = sum(len(pssm[index[t]]) > LONG_COLUMNS for t, _, _ in hits.values())
        self.judged["long_hits"] = self.judged.get("long_hits", 0) + int(long)
        return super()._judge(job, proteins, hits, index, pssm, db_positions)
