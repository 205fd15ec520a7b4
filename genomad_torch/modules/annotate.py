"""annotate module: gene calling + marker annotation + taxonomy.

Port of ``genomad_tpu/modules/annotate.py`` (contract parity with
genomad/modules/annotate.py:50-240): runs the gene caller over the input
FASTA, searches the predicted proteins against the marker-profile DB on the
GPU (genomad_torch.ops.protein_search, kernel K1), joins gene metadata x
search hits x marker annotations into the 20-column <prefix>_genes.tsv, and
writes the per-contig taxonomy table. The output files are byte-for-byte
the JAX module's. ``device`` is where the search runs (None = cuda; raises
without a card, before anything is written); ``mesh``, as in the JAX
module, runs it over a (data, db) mesh. When neither is given and a process
group of several ranks is joined, the search runs over one cell per rank
(``default_search_mesh``).
"""

from __future__ import annotations

import sys
from pathlib import Path

from genomad_torch import database, sequence, taxonomy, trace, utils
from genomad_torch.device import resolve_device
from genomad_torch.ops import gene_calling, protein_search
from genomad_torch.paths import GenomadOutputs


def default_search_mesh():
    """A balanced (data, db) mesh of one cell per rank when a process group
    of more than one rank is joined, else None. The profile DB shards over
    'db' (the native replacement for the reference's serial ``--splits``
    chunking, genomad/mmseqs2.py:83-95) and the query pairs over both axes.
    The ranks run their cells at once; one process walks its cells one
    after another, so without a group the search stays on one card."""
    import torch.distributed as dist

    from genomad_torch.parallel import mesh as meshlib

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return None
    n_data, n_db = meshlib.balanced_factorization(dist.get_world_size())
    return meshlib.make_mesh(n_data=n_data, n_db=n_db)


def run_search(proteins_path, output_path, db, use_minimal_db=False, use_integrase_db=False, sensitivity=4.2, evalue=1e-3, device=None, threads=None, mesh=None):
    """Search a protein FASTA against the packed profile DB on ``device``
    and write the best-hit TSV (columns: qheader, target, evalue, bits[,
    taxid] — the convertalis contract, genomad/mmseqs2.py:159-174). With a
    mesh of several cells the search runs over it; with neither ``device``
    nor ``mesh`` given, over ``default_search_mesh()`` when that is one."""
    profile_db = db.get_profile_db(use_minimal_db=use_minimal_db, use_integrase_db=use_integrase_db)
    include_taxid = not use_integrase_db
    names, seqs, headers = [], [], {}
    for seq in sequence.read_fasta(proteins_path):
        names.append(seq.accession)
        headers[seq.accession] = seq.header
        seqs.append(seq.seq)
    if mesh is None and device is None:
        mesh = default_search_mesh()
    hits = protein_search.search(
        names, seqs, profile_db, sensitivity=sensitivity,
        evalue_threshold=evalue, device=device, mesh=mesh, n_threads=threads,
    )
    with open(output_path, "w") as fout:
        for name in names:
            if name not in hits:
                continue
            target, ev, bits, taxid = hits[name]
            row = [headers[name], target, f"{ev:.3E}", str(bits)]
            if include_taxid:
                row.append(str(taxid))
            fout.write("\t".join(row) + "\n")
    return hits


def get_matches(mmseqs2_output: Path, include_taxid: bool = True) -> dict:
    """Parse a best-hit TSV back into {gene: (marker, evalue, bits, taxid)}
    (reference: genomad/mmseqs2.py:198-212; taxid 0 -> 1)."""
    matches = {}
    if not mmseqs2_output.is_file():
        raise FileNotFoundError(f"{mmseqs2_output} was not found.")
    for line in utils.read_file(mmseqs2_output):
        fields = line.rstrip("\n").split("\t")
        gene = fields[0].split()[0]
        if include_taxid:
            taxid = int(fields[4]) if fields[4] != "0" else 1
            matches[gene] = (fields[1], float(fields[2]), int(fields[3]), taxid)
        else:
            matches[gene] = (fields[1], float(fields[2]), int(fields[3]), 1)
    return matches


def write_genes_output(genes_output, database_obj, prodigal_obj, gene_matches: dict):
    """20-column genes table (reference: annotate.py:8-47)."""
    marker_annotation = database_obj.get_marker_annotation()
    taxdb = database_obj.get_taxdb()
    with open(genes_output, "w") as fout:
        fout.write(
            "gene\tstart\tend\tlength\tstrand\tgc_content\tgenetic_code\trbs_motif\tmarker\t"
            "evalue\tbitscore\tuscg\tplasmid_hallmark\tvirus_hallmark\ttaxid\ttaxname\t"
            "annotation_conjscan\tannotation_amr\tannotation_accessions\tannotation_description\n"
        )
        for contig, gene_num, start, end, strand, rbs, code, gc in prodigal_obj.proteins():
            gene = f"{contig}_{gene_num}"
            match, ev, bits, taxid = gene_matches.get(gene, ("NA", "NA", "NA", 1))
            taxname = taxdb.taxid2name.get(taxid, "NA") if taxid != 1 else "NA"
            uscg, p_hallmark, v_hallmark, conjscan, amr, accession, description = (
                marker_annotation.get(match, (0, 0, 0, "NA", "NA", "NA", "NA"))
            )
            gene_length = end - start + 1
            fout.write(
                f"{gene}\t{start}\t{end}\t{gene_length}\t{strand}\t{gc:.3f}\t{code}\t{rbs}\t"
                f"{match}\t{ev}\t{bits}\t{uscg}\t{p_hallmark}\t{v_hallmark}\t"
                f"{taxid}\t{taxname}\t{conjscan}\t{amr}\t{accession}\t{description}\n"
            )


@trace.spanned("module.annotate")
def main(
    input_path,
    output_path,
    database_path,
    use_minimal_db=False,
    restart=False,
    threads=None,
    verbose=True,
    lenient_taxonomy=False,
    full_ictv_lineage=False,
    sensitivity=4.2,
    evalue=1e-3,
    splits=0,
    cleanup=False,
    device=None,
    mesh=None,
):
    if mesh is None and device is None:
        mesh = default_search_mesh()
    device = resolve_device(device)
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.annotate_log, verbose)
    parameter_dict = {
        "use_minimal_db": use_minimal_db,
        "sensitivity": sensitivity,
        "evalue": evalue,
    }

    utils.display_header(
        console,
        "annotate",
        "This will perform gene calling in the input sequences and annotate "
        "the predicted proteins with geNomad's markers.",
        outputs.annotate_dir,
        [
            outputs.annotate_execution_info,
            outputs.annotate_genes_output,
            outputs.annotate_taxonomy_output,
            outputs.annotate_mmseqs2_output,
            outputs.annotate_proteins_output,
        ],
        [
            "execution parameters",
            "gene annotation data",
            "taxonomic assignment",
            "protein search output file",
            "protein FASTA file",
        ],
    )
    if splits:
        console.log(
            "--splits is a no-op in genomad-torch: the profile database is "
            "staged whole on the device."
        )

    if not sequence.check_fasta(input_path):
        console.error(f"{input_path} is either empty or contains duplicate identifiers.")
        sys.exit(1)

    skip = False
    if (
        outputs.annotate_execution_info.exists()
        and (outputs.annotate_proteins_output.exists() or outputs.annotate_genes_output.exists())
        and not restart
    ):
        if utils.compare_executions(input_path, parameter_dict, outputs.annotate_execution_info):
            skip = True
            console.log("Previous execution detected. Steps will be skipped unless their outputs are not found.")

    outputs.annotate_dir.mkdir(exist_ok=True)
    utils.write_execution_info("annotate", input_path, parameter_dict, outputs.annotate_execution_info)

    database_obj = database.Database(database_path)

    # --- gene calling ---
    prodigal_obj = gene_calling.Prodigal(input_path, outputs.annotate_proteins_output)
    if skip and outputs.annotate_proteins_output.exists():
        console.log(f"{outputs.annotate_proteins_output.name} was found. Skipping gene prediction.")
    else:
        with console.timer("gene-calling"):
            prodigal_obj.run_parallel_prodigal(threads)
        console.log(f"Proteins predicted and written to {outputs.annotate_proteins_output.name}.")

    # --- marker search ---
    if skip and outputs.annotate_mmseqs2_output.exists():
        console.log(f"{outputs.annotate_mmseqs2_output.name} was found. Skipping protein annotation.")
    else:
        with console.timer("marker-search"):
            run_search(
                outputs.annotate_proteins_output,
                outputs.annotate_mmseqs2_output,
                database_obj,
                use_minimal_db=use_minimal_db,
                sensitivity=sensitivity,
                evalue=evalue,
                device=device,
                threads=threads,
                mesh=mesh,
            )
        console.log(
            f"Proteins annotated using the geNomad database (v{database_obj.version}) "
            f"and written to {outputs.annotate_mmseqs2_output.name}."
        )
    gene_matches = get_matches(outputs.annotate_mmseqs2_output, include_taxid=True)

    # --- genes table ---
    write_genes_output(outputs.annotate_genes_output, database_obj, prodigal_obj, gene_matches)
    console.log(f"Gene data written to {outputs.annotate_genes_output.name}.")

    # --- taxonomy ---
    taxonomy.write_taxonomic_assignment(
        outputs.annotate_taxonomy_output,
        outputs.annotate_genes_output,
        database_obj,
        lenient_taxonomy=lenient_taxonomy,
        full_ictv_lineage=full_ictv_lineage,
    )
    console.log(f"Taxonomic assignment written to {outputs.annotate_taxonomy_output.name}.")

    console.log("genomad-torch annotate finished!", style="yellow")
