"""A run at a size the CPU holds, with the port's timed path broken
underneath, comes out not correct; the sound run and the control put in
the port's place read as they should."""

import numpy as np


def test_sound_runs_are_correct(tiny_run):
    for cell in ("nn.metagenome", "e2e.metagenome", "e2e.isolate"):
        result = tiny_run(cell)
        assert result["correct"], result["checks"]
        assert result["attempted"] >= 1 and result["failed"] == 0


def _patch_predict(monkeypatch, wrap):
    from genomad_torch.ops import nn_pipeline

    original = nn_pipeline.predict_windows
    monkeypatch.setattr(nn_pipeline, "predict_windows", lambda model, windows, *a, **k: wrap(original, model, windows, *a, **k))


def test_half_the_batch_left_out(tiny_run, monkeypatch):
    """Every other window unscored: each contig's mean is over the rest.
    (In the end-to-end cell the batch is the search's queries, below.)"""

    def half(original, model, windows, *a, **k):
        out = original(model, windows[::2], *a, **k)
        return np.repeat(out, 2, axis=0)[: len(windows)]

    _patch_predict(monkeypatch, half)
    result = tiny_run("nn.metagenome")
    assert not result["correct"] and result["checks"]["nn_score_gap"]["value"] > result["checks"]["nn_score_gap"]["limit"]


def test_an_answer_altered_where_it_is_produced(tiny_run, monkeypatch):
    def altered(original, model, windows, *a, **k):
        out = original(model, windows, *a, **k)
        out[0] = out[0][[1, 2, 0]]
        return out

    _patch_predict(monkeypatch, altered)
    assert not tiny_run("nn.metagenome")["correct"]


def test_the_control_in_the_ports_place(tiny_run, monkeypatch):
    """The reference computed in float8 instead of the bf16 forward."""
    from benchmark import manifest as mf
    from benchmark.reference import igloo

    w = igloo.widths(mf.config("genomad-nn"))
    control = igloo.Reference(igloo.init_params(w, 0), w, "cpu", quantize=True)
    _patch_predict(monkeypatch, lambda original, model, windows, *a, **k: control.forward_bases(windows))
    result = tiny_run("nn.metagenome")
    assert not result["correct"] and result["checks"]["nn_score_gap"]["value"] > result["checks"]["nn_score_gap"]["limit"]


def _patch_search(monkeypatch, wrap):
    from genomad_torch.ops import protein_search

    original = protein_search.search
    monkeypatch.setattr(protein_search, "search", lambda names, seqs, db, **k: wrap(original, names, seqs, db, **k))


def test_half_the_queries_left_out_of_the_search(tiny_run, monkeypatch):
    """The end-to-end cell's batch: every other protein left out of the marker search."""
    _patch_search(monkeypatch, lambda original, names, seqs, db, **k: original(names[::2], seqs[::2], db, **k))
    result = tiny_run("e2e.metagenome")
    assert not result["correct"] and result["checks"]["planted_hits_missed"]["value"] > 0


def test_a_hit_altered_where_it_is_produced(tiny_run, monkeypatch):
    def altered(original, names, seqs, db, **k):
        hits = original(names, seqs, db, **k)
        if db.n_profiles > 16:  # the marker search, not the integrase one
            gene = sorted(hits)[0]
            target, ev, bits, taxid = hits[gene]
            hits[gene] = (target, ev, bits - 1, taxid)
        return hits

    _patch_search(monkeypatch, altered)
    result = tiny_run("e2e.metagenome")
    assert not result["correct"] and result["checks"]["hits_differing"]["value"] > 0


def test_half_the_gene_calls_left_out(tiny_run, monkeypatch):
    """Every other protein dropped where the gene caller writes them."""
    from genomad_torch.ops import gene_calling

    original = gene_calling.Prodigal.run_parallel_prodigal

    def half(self, *a, **k):
        original(self, *a, **k)
        records = self.prodigal_output.read_text().split(">")[1:]
        self.prodigal_output.write_text("".join(">" + r for r in records[::2]))

    monkeypatch.setattr(gene_calling.Prodigal, "run_parallel_prodigal", half)
    result = tiny_run("e2e.isolate")
    assert not result["correct"] and result["checks"]["genes_missed_pct"]["value"] >= 50


def test_a_provirus_altered_where_it_is_produced(tiny_run, monkeypatch):
    """Each provirus ends one gene early."""
    from genomad_torch.modules import find_proviruses as fp

    original = fp.yield_proviruses

    def shorter(genetable, labels, *a, **k):
        for p in original(genetable, labels, *a, **k):
            p.end = genetable.ends[genetable.ends.index(p.end) - 1]
            yield p

    monkeypatch.setattr(fp, "yield_proviruses", shorter)
    result = tiny_run("e2e.isolate")
    assert not result["correct"] and result["checks"]["provirus_rows_differing"]["value"] > 0


def test_the_proviruses_left_out(tiny_run, monkeypatch):
    from genomad_torch.modules import find_proviruses as fp

    monkeypatch.setattr(fp, "yield_proviruses", lambda *a, **k: iter(()))
    result = tiny_run("e2e.isolate")
    checks = result["checks"]
    assert not result["correct"] and checks["prophages_missed"]["value"] > 0 and checks["provirus_rows_differing"]["value"] > 0


def test_the_integrase_hits_left_out(tiny_run, monkeypatch):
    _patch_search(monkeypatch, lambda original, names, seqs, db, **k: {} if db.n_profiles <= 16 else original(names, seqs, db, **k))
    result = tiny_run("e2e.isolate")
    assert not result["correct"] and result["checks"]["integrase_genes_differing"]["value"] > 0
