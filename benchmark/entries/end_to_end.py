"""The ``end-to-end`` command's body, ``genomad_torch.cli.run_end_to_end``,
with the upstream defaults (``-s 4.2``, E-value 1e-3, batch 128,
find-proviruses on, score calibration off, default summary filters, the
card, every host core) against its DB, on a fresh output directory per
job. Jobs share the process and the port's in-process DB cache, as a
service classifying many samples would.

Spans: annotate (on ``run_end_to_end``'s worker thread, with the change of
``protein_search.STATS`` over it), its gene calling, the NN module and its
encoding and inference, find-proviruses, marker classification,
aggregation and summary.

Check, on two jobs of the window drawn from the seed:
- the gene calls against every gene the generator wrote: the share of
  written genes not called at their start, stop and strand
  (``genes_missed_pct``), and of calls that end at no written gene's stop
  (``calls_unwritten_pct``);
- the marker search's best hits: each reported hit's bitscore and E-value
  against the reference's Smith-Waterman of that gene and profile, which
  must also pass the E-value and coverage gates (``hits_differing``); each
  planted marker gene that the gene caller called, against the reference's
  alignment with its planted profile: where that passes the gates, the
  port must report a hit at least as strong (``planted_hits_missed``);
- find-proviruses: which genes of the target contigs the integrase search
  reports, against the reference's alignment of each with every integrase
  profile (``integrase_genes_differing``); the provirus table against
  ``reference.provirus`` run on the judged gene calls, marker hits and
  integrases and the program's tRNAs (``provirus_rows_differing``); each
  planted prophage against the table: a row that covers half of it or more
  (``prophages_missed``; its integrase gene is judged by the integrase
  check, and may go uncalled);
- the NN: the window cache and the contig scores (``window_rows_differing``,
  ``nn_score_gap``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from benchmark import dbsynth
from benchmark.entries.common import Base, nn_check, records
from benchmark.reference import provirus, sw

MIN_COV = np.float32(0.2)  # --cov-mode 2 -c 0.2 (genomad/mmseqs2.py:123-140)
# an E-value this close to the gate (relative) is decided by f32 rounding,
# which the reference does not follow: such a pair is not judged
BORDER = 1e-4
_HEADER = re.compile(r"(.+)_(\d+) # (\d+) # (\d+) # (-1|1) ")


class Entry(Base):
    def __init__(self, name: str, config: dict, device, cache: Path):
        super().__init__(config, device)
        self.db, _ = dbsynth.ensure_db(name, config["db"], cache)
        self.sw_device = "cuda" if self.on_card else "cpu"

    def run(self, fasta: Path, out: Path) -> None:
        from genomad_torch import cli

        c = self.config
        cli.run_end_to_end(
            fasta, out, self.db.db_dir, verbose=False, sensitivity=c["sensitivity"], batch_size=c["batch_size"],
            disable_find_proviruses=not c["find_proviruses"], enable_score_calibration=c["score_calibration"],
            device=self.device, threads=c["threads"],
        )

    def settle(self) -> None:
        from genomad_torch.ops import protein_search

        protein_search.join_prestage()
        super().settle()

    def check_sample(self, rng) -> set:
        return {0, int(rng.integers(1, self.config["check_jobs_within"]))}

    def span_points(self) -> list:
        from genomad_torch.modules import (
            aggregated_classification, annotate, find_proviruses, marker_classification,
            nn_classification, summary,
        )
        from genomad_torch.ops import gene_calling, nn_pipeline, protein_search

        return [
            (annotate, "main", "annotate", protein_search.STATS),
            (gene_calling.Prodigal, "run_parallel_prodigal", "gene_calling", None),
            (annotate, "run_search", "marker_search", None),
            (nn_classification, "main", "nn_module", None),
            (nn_pipeline, "encode_windows", "nn_encode", None),
            (nn_pipeline, "predict_windows", "nn_inference", None),
            (find_proviruses, "main", "find_proviruses", None),
            (marker_classification, "main", "marker_classification", None),
            (aggregated_classification, "main", "aggregated_classification", None),
            (summary, "main", "summary", None),
        ]

    # ------------------------------------------------------------ the check

    def check(self, pool, fastas, kept, workdir: Path) -> dict:
        n = dict.fromkeys(
            ("genes_missed", "calls_unwritten", "hits_differing", "planted_hits_missed", "integrase_genes_differing",
             "provirus_rows_differing", "prophages_missed"), 0)
        self.judged = {"jobs": len(kept), "genes": 0, "calls": 0, "hits": 0, "planted_judged": 0, "planted_called": 0,
                       "planted": 0, "integrase_queries": 0, "integrase_genes": 0, "provirus_contigs": 0,
                       "provirus_contigs_at_threshold": 0, "provirus_tables_allowed": 0, "proviruses": 0, "prophages": 0}
        pending = []
        for k, i, out in kept:
            prefix = fastas[i].stem
            proteins = _faa(out / f"{prefix}_annotate" / f"{prefix}_proteins.faa")
            missed, unwritten = _calls_against_truth(pool[i], proteins)
            n["genes_missed"] += missed
            n["calls_unwritten"] += unwritten
            self.judged["genes"] += len(pool[i].genes)
            self.judged["calls"] += len(proteins)
            pending.append((pool[i], proteins, _hits(out / f"{prefix}_annotate" / f"{prefix}_mmseqs2.tsv"), out / f"{prefix}_find_proviruses", prefix))
        index = {str(name): j for j, name in enumerate(np.load(self.db.profiles_file())["names"])}
        need = sorted({index[t] for _, _, hits, _, _ in pending for t, _, _ in hits.values()} | {p for job, *_ in pending for *_, p in job.planted})
        pssms, lengths = dbsynth.load_profiles(self.db.profiles_file(), need)
        pssm = dict(zip(need, pssms))
        db_positions = int(lengths.sum())
        integrases = dbsynth.load_profiles(self.db.db_dir / "genomad_integrase_profiles.npz", range(self.config["db"]["integrase_profiles"]))[0]
        features = _marker_features(self.db.db_dir / "genomad_marker_metadata.tsv")
        for job, proteins, hits, fp_dir, prefix in pending:
            hd, ms = self._judge(job, proteins, hits, index, pssm, db_positions)
            n["hits_differing"] += hd
            n["planted_hits_missed"] += ms
            ig, rows, lost = self._judge_proviruses(job, proteins, hits, features, integrases, fp_dir, prefix)
            n["integrase_genes_differing"] += ig
            n["provirus_rows_differing"] += rows
            n["prophages_missed"] += lost
        rows, gap = nn_check(self.reference(), [(fastas[i], out) for _, i, out in kept], self.judged)
        limits = self.config["limits"]
        genes = max(self.judged["genes"], 1)
        values = {
            "genes_missed_pct": 100.0 * n["genes_missed"] / genes,
            "calls_unwritten_pct": 100.0 * n["calls_unwritten"] / genes,
            **{k: n[k] for k in ("hits_differing", "planted_hits_missed", "integrase_genes_differing",
                                 "provirus_rows_differing", "prophages_missed")},
            "window_rows_differing": rows,
            "nn_score_gap": gap,
        }
        return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}

    def _judge(self, job, proteins, hits, index, pssm, db_positions) -> tuple[int, int]:
        """(reported hits the reference does not bear out, planted genes the
        port missed) in one job."""
        seqs = {h.split()[0]: s for h, s in proteins}
        n_gate = sum(len(s) for s in seqs.values())
        by_end = {}
        for h, _ in proteins:
            m = _HEADER.match(h)
            by_end[(m.group(1), int(m.group(4)), int(m.group(5)))] = h.split()[0]
        pairs = [(g, index[t]) for g, (t, _, _) in hits.items()]
        planted = [(by_end[(c, end, 1)], p) for c, _, end, p in job.planted if (c, end, 1) in by_end]
        everything = pairs + planted
        self.judged["hits"] += len(pairs)
        self.judged["planted"] += len(job.planted)
        self.judged["planted_called"] += len(planted)
        if not everything:
            return 0, 0
        score, _, end_j, start_j = sw.align([sw.encode(seqs[g]) for g, _ in everything], [pssm[p] for _, p in everything], self.sw_device)
        plen = np.array([len(pssm[p]) for _, p in everything])
        ev = sw.gate_evalue(score, plen, n_gate)
        cov = ((end_j - start_j + 1).astype(np.float32) / plen.astype(np.float32)).astype(np.float32)
        evalue = self.config["evalue"]
        judged = np.abs(np.log(ev / evalue)) > BORDER
        passes = (ev <= evalue) & (cov >= MIN_COV)
        bits = sw.int_bitscore(score)
        differing = 0
        for n, (g, p) in enumerate(pairs):
            _, ev_text, got_bits = hits[g]
            want_ev = f"{sw.reported_evalue(bits[n], len(seqs[g]), db_positions):.3E}"
            if got_bits != bits[n] or ev_text != want_ev or (judged[n] and not passes[n]):
                differing += 1
        missed = 0
        for n, (g, p) in enumerate(planted, start=len(pairs)):
            self.judged["planted_judged"] += int(judged[n] and passes[n])
            if judged[n] and passes[n] and (g not in hits or hits[g][2] < bits[n]):
                missed += 1
        return differing, missed

    def _judge_proviruses(self, job, proteins, hits, features, integrases, fp_dir: Path, prefix: str) -> tuple[int, int, int]:
        """(integrase genes that differ, provirus rows that differ, planted
        prophages missed) in one job."""
        genes = []  # (gene, contig, start, end, protein), in the order called
        for h, seq in proteins:
            m = _HEADER.match(h)
            genes.append((h.split()[0], m.group(1), int(m.group(3)), int(m.group(4)), seq))
        feature = {g[0]: features.get(hits[g[0]][0]) if g[0] in hits else None for g in genes}
        contigs: dict = {}
        for g in genes:
            contigs.setdefault(g[1], []).append(g)

        def is_marker(gene, kind):
            return feature[gene] is not None and feature[gene][0].startswith(kind)

        targets = [c for c, gs in contigs.items() if any(is_marker(g[0], "C") for g in gs) and any(is_marker(g[0], "V") for g in gs)]
        queries = [g for c in targets for g in contigs[c]]
        said = set(_hits(fp_dir / f"{prefix}_provirus_mmseqs2.tsv"))
        found, border = self._integrase_genes(queries, integrases)
        differing = len((found ^ said) - border)
        self.judged["integrase_queries"] += len(queries)
        self.judged["integrase_genes"] += len(found)
        trnas: dict = {}
        trna_file = fp_dir / f"{prefix}_provirus_aragorn.tsv"
        for line in trna_file.read_text().splitlines() if trna_file.exists() else []:
            name, start, end = line.split("\t")
            trnas.setdefault(name.rsplit("_", 2)[0], []).append((int(start), int(end)))
        got = _proviruses(fp_dir / f"{prefix}_provirus.tsv")
        rows = 0
        for c in targets:
            gs = contigs[c]
            f = [feature[g[0]] or ("", 0.0, 0.0) for g in gs]
            contig = provirus.Contig(
                c, np.array([g[2] for g in gs]), np.array([g[3] for g in gs]),
                np.array([x[1] for x in f]), np.array([x[2] for x in f]),
                np.array([x[0].startswith("C") for x in f]), np.array([x[0].startswith("V") for x in f]),
                np.array([g[0] in found or (g[0] in border and g[0] in said) for g in gs]), trnas.get(c, []),
            )
            tables = provirus.readings(contig)
            if tables is None:
                self.judged["provirus_contigs_at_threshold"] += 1
                continue
            said_here = {k: v for k, v in got.items() if k[0] == c}
            rows += min(_rows_differing({r[:4] + r[5:]: r[4] for r in t}, said_here) for t in tables)
            self.judged["provirus_contigs"] += 1
            self.judged["proviruses"] += len(tables[0])
            self.judged["provirus_tables_allowed"] += len(tables) - 1
        rows += sum(k[0] not in targets for k in got)
        self.judged["prophages"] += len(job.prophages)
        lost = 0
        for c, begin, end in job.prophages:
            lost += not any(k[0] == c and min(end, k[2]) - max(begin, k[1]) + 1 >= (end - begin + 1) / 2 for k in got)
        return differing, rows, lost

    def _integrase_genes(self, queries: list, integrases: list) -> tuple[set, set]:
        """(genes with an integrase alignment that passes the gates, genes
        whose only passing alignments lie at the E-value gate), each of
        ``queries`` aligned with every integrase profile."""
        if not queries:
            return set(), set()
        n_gate = sum(len(g[4]) for g in queries)
        codes = [sw.encode(g[4]) for g in queries]
        pairs = [(q, p) for q in range(len(queries)) for p in range(len(integrases))]
        score, _, end_j, start_j = sw.align([codes[q] for q, _ in pairs], [integrases[p] for _, p in pairs], self.sw_device)
        plen = np.array([len(integrases[p]) for _, p in pairs])
        ev = sw.gate_evalue(score, plen, n_gate)
        cov = ((end_j - start_j + 1).astype(np.float32) / plen.astype(np.float32)).astype(np.float32)
        at_gate = np.abs(np.log(ev / self.config["integrase_evalue"])) <= BORDER
        passes = (ev <= self.config["integrase_evalue"]) & (cov >= MIN_COV)
        passing, unsure = set(), set()
        for (q, _), a, b in zip(pairs, passes, at_gate):
            (unsure if b else passing if a else set()).add(queries[q][0])
        return passing, unsure - passing


def _faa(path: Path) -> list:
    return records(path) if path.exists() else []


def _hits(path: Path) -> dict:
    """gene -> (target, E-value as written, int bitscore)."""
    out = {}
    if path.exists():
        for line in path.read_text().splitlines():
            f = line.split("\t")
            out[f[0].split()[0]] = (f[1], f[2], int(f[3]))
    return out


def _calls_against_truth(job, proteins) -> tuple[int, int]:
    """(written genes not called at their start, stop and strand, calls
    whose stop is no written gene's)."""
    calls = set()
    for h, _ in proteins:
        m = _HEADER.match(h)
        calls.add((m.group(1), int(m.group(3)), int(m.group(4)), int(m.group(5))))
    written = {(c, b, e, 1) for c, b, e, _ in job.genes}
    stops = {(c, e) for c, _, e, _ in job.genes}
    return len(written - calls), sum(s != 1 or (c, e) not in stops for c, _, e, s in calls)


def _rows_differing(want: dict, got: dict) -> int:
    return len(want.keys() ^ got.keys()) + sum(abs(want[k] - got[k]) > 1e-3 for k in want.keys() & got.keys())


def _marker_features(path: Path) -> dict:
    """marker -> (specificity class, spm_c, spm_v), from the DB's metadata."""
    out = {}
    for line in path.read_text().splitlines()[1:]:
        f = line.split("\t")
        out[f[0]] = (f[2], float(f[4]), float(f[6]))
    return out


def _proviruses(path: Path) -> dict:
    """(contig, start, end, genes, in edge, integrase genes) -> v_vs_c, from
    a provirus table."""
    out = {}
    for line in path.read_text().splitlines()[1:] if path.exists() else []:
        f = line.split("\t")
        ints = () if f[8] == "NA" else tuple(int(x.rsplit("_", 1)[1]) for x in f[8].split(";"))
        out[(f[1], int(f[2]), int(f[3]), int(f[5]), f[7] == "True", ints)] = float(f[6])
    return out
