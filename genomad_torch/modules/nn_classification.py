"""nn-classification module: sequence-only classification on the card.

Port of ``genomad_tpu/modules/nn_classification.py``, with its pipeline
contract (genomad/modules/nn_classification.py:21-427): same outputs
(<prefix>_nn_classification.{tsv,npz}, provirus variants, the
encoded-sequence cache dir, execution-info JSON), same skip/resume rules, and
the same window/merge numerics. The compute path is the PyTorch IGLOO model
(genomad_torch.models.igloo) with its hand-written kernels. ``device=None``
runs on the card and raises without one; ``device="cpu"`` runs the plain
PyTorch versions of the kernels. Spans (``genomad_torch.trace``):
``module.nn_classification`` around ``nn.check_fasta``, ``nn.encode``,
``nn.cache_write`` (the window cache's compressed write, its deflate split
over the ``threads`` by ``utils.savez_compressed_threaded``), ``nn.model_load``,
``nn.inference`` and ``nn.tables`` (the scores' npz and tsv); the input's
``md5`` for the execution record; counters ``nn.windows``, ``nn.cache_bytes``
and ``nn.cache_chunks``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

from genomad_torch import sequence, trace, utils
from genomad_torch.device import resolve_device
from genomad_torch.models import igloo, weights
from genomad_torch.ops import nn_pipeline
from genomad_torch.paths import GenomadOutputs


def _write_scores_tsv(path: Path, names, predictions) -> None:
    with open(path, "w") as fout:
        fout.write("seq_name\tchromosome_score\tplasmid_score\tvirus_score\n")
        for name, scores in zip(names, predictions):
            formatted = "".join(f"{x:.4f}\t" for x in scores).strip()
            fout.write(f"{name}\t{formatted}\n")


def _classify_fasta(
    fasta_path, cache_dir, cache_npz, id_key, single_window, batch_size, threads, device, mesh, console, skip
):
    """Encode (or load cached) windows, run the model, merge per contig. The
    window cache is deflated on ``threads`` threads (``None``: every core)."""
    if skip and cache_npz.exists():
        console.log(f"{cache_npz.name} was found. Skipping sequence encoding.")
        cached = np.load(cache_npz)
        bases, names, ids = cached["bases"], cached[f"{id_key}_names"], cached[f"{id_key}_ids"]
    else:
        if cache_dir.is_dir():
            shutil.rmtree(cache_dir)
        cache_dir.mkdir(parents=True)
        with console.timer("window-encoding", span="nn.encode"):
            bases, names, ids = nn_pipeline.encode_windows(fasta_path, single_window)
        with trace.span("nn.cache_write"):
            chunks = utils.savez_compressed_threaded(
                cache_npz,
                threads,
                bases=bases,
                **{f"{id_key}_names": names, f"{id_key}_ids": ids},
            )
        trace.count_many({"nn.cache_bytes": cache_npz.stat().st_size, "nn.cache_chunks": chunks["bases"]})
        console.log(f"Encoded {bases.shape[0]} windows from {len(names)} sequences.")
    if not len(names):
        return names, np.zeros((0, igloo.N_CLASSES), dtype=np.float32)
    trace.count("nn.windows", len(bases))
    with trace.span("nn.model_load"):
        model = igloo.IglooClassifier(weights.load_params(console), device=device)
    with console.timer("nn-inference", span="nn.inference"):
        # batch progress display with time-remaining, matching the
        # reference's NN prediction bar (nn_classification.py:300-318)
        if console.verbose and getattr(console, "_rich", None) is not None:
            import rich.progress

            with rich.progress.Progress(
                rich.progress.TextColumn("[progress.description]{task.description}"),
                rich.progress.BarColumn(),
                rich.progress.MofNCompleteColumn(),
                rich.progress.TimeRemainingColumn(),
                console=console._rich,
                transient=True,
            ) as bar:
                task = bar.add_task("Classifying windows", total=1)

                def progress(done, total):
                    bar.update(task, completed=done, total=total)

                window_preds = nn_pipeline.predict_windows(
                    model, bases, batch_size, progress=progress, mesh=mesh
                )
        else:
            window_preds = nn_pipeline.predict_windows(model, bases, batch_size, mesh=mesh)
    predictions = nn_pipeline.segment_mean(window_preds, ids, len(names))
    return names, predictions


@trace.spanned("module.nn_classification")
def main(
    input_path,
    output_path,
    single_window=False,
    batch_size=128,
    restart=False,
    threads=None,
    verbose=True,
    cleanup=False,
    skip_proviruses=False,
    device=None,
    mesh=None,
):
    """``skip_proviruses``: classify contig windows only — used by the
    end-to-end stage overlap, where this module runs
    CONCURRENTLY with annotate and must not read find-proviruses outputs
    that a later module invocation will (re)write. With ``restart`` it
    also deletes stale provirus score files so the post-find-proviruses
    second call recomputes them from the fresh provirus FASTA.

    ``device``: where the model runs; ``None`` is the card (raises when CUDA
    is absent), ``"cpu"`` runs the plain PyTorch path. ``mesh``: the
    windows split over its ``data`` cells (``nn_pipeline.predict_windows``)."""
    device = resolve_device(device)
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.nn_classification_log, verbose)
    parameter_dict = {"single_window": single_window}

    classify_proviruses = not skip_proviruses and utils.check_provirus_execution(
        prefix, input_path, output_path
    )
    if skip_proviruses and restart:
        for stale in (
            outputs.provirus_nn_classification_npz_output,
            outputs.provirus_nn_classification_output,
        ):
            if stale.exists():
                stale.unlink()

    output_files = [
        outputs.nn_classification_execution_info,
        outputs.encoded_sequences_dir,
        outputs.nn_classification_output,
        outputs.nn_classification_npz_output,
    ]
    descriptions = [
        "execution parameters",
        "directory containing encoded sequence data",
        "contig classification: tabular format",
        "contig classification: binary format",
    ]
    if classify_proviruses:
        output_files += [
            outputs.encoded_proviruses_dir,
            outputs.provirus_nn_classification_output,
            outputs.provirus_nn_classification_npz_output,
        ]
        descriptions += [
            "directory containing encoded provirus data",
            "provirus classification: tabular format",
            "provirus classification: binary format",
        ]
    utils.display_header(
        console,
        "nn-classification",
        "This will classify the input sequences into chromosome, plasmid, or "
        "virus based on the nucleotide sequence.",
        outputs.nn_classification_dir,
        output_files,
        descriptions,
    )

    with trace.span("nn.check_fasta"):
        fasta_ok = sequence.check_fasta(input_path)
    if not fasta_ok:
        console.error(
            f"{input_path} is either empty or contains multiple entries with "
            "the same identifier. Please check your input FASTA file."
        )
        sys.exit(1)

    # Skip/resume decision (reference: nn_classification.py:176-198)
    skip = False
    if (
        outputs.nn_classification_execution_info.exists()
        and any(p.exists() for p in output_files)
        and not restart
    ):
        if utils.compare_executions(input_path, parameter_dict, outputs.nn_classification_execution_info):
            skip = True
            console.log("Previous execution detected. Steps will be skipped unless their outputs are not found.")
        else:
            console.log("The input file or the parameters changed since the last execution. Previous outputs will be overwritten.")

    outputs.nn_classification_dir.mkdir(exist_ok=True)
    utils.write_execution_info(
        "nn_classification", input_path, parameter_dict, outputs.nn_classification_execution_info
    )

    # --- contigs ---
    if skip and outputs.nn_classification_npz_output.exists():
        console.log(f"{outputs.nn_classification_npz_output.name} was found. Skipping sequence classification.")
        cached = np.load(outputs.nn_classification_npz_output)
        contig_names, contig_predictions = cached["contig_names"], cached["predictions"]
    else:
        contig_names, contig_predictions = _classify_fasta(
            input_path,
            outputs.encoded_sequences_dir,
            outputs.seq_window_id_output,
            "contig",
            single_window,
            batch_size,
            threads,
            device,
            mesh,
            console,
            skip,
        )
        if not len(contig_names):
            console.error("No sequences were found. Please check your input FASTA.")
            sys.exit(1)
        with trace.span("nn.tables"):
            np.savez_compressed(
                outputs.nn_classification_npz_output,
                contig_names=contig_names,
                predictions=contig_predictions,
            )
        console.log(f"Sequence classification written to {outputs.nn_classification_npz_output.name}.")
    with trace.span("nn.tables"):
        _write_scores_tsv(outputs.nn_classification_output, contig_names, contig_predictions)
    console.log(f"Sequence classification written to {outputs.nn_classification_output.name}.")

    # --- proviruses (second pass, reference: nn_classification.py:354-425) ---
    if classify_proviruses:
        if skip and outputs.provirus_nn_classification_npz_output.exists():
            console.log(
                f"{outputs.provirus_nn_classification_npz_output.name} was found. Skipping provirus classification."
            )
            cached = np.load(outputs.provirus_nn_classification_npz_output)
            provirus_names, provirus_predictions = cached["provirus_names"], cached["predictions"]
        else:
            provirus_names, provirus_predictions = _classify_fasta(
                outputs.find_proviruses_nucleotide_output,
                outputs.encoded_proviruses_dir,
                outputs.provirus_window_id_output,
                "provirus",
                single_window,
                batch_size,
                threads,
                device,
                mesh,
                console,
                skip,
            )
            with trace.span("nn.tables"):
                np.savez_compressed(
                    outputs.provirus_nn_classification_npz_output,
                    provirus_names=provirus_names,
                    predictions=provirus_predictions,
                )
        with trace.span("nn.tables"):
            _write_scores_tsv(
                outputs.provirus_nn_classification_output, provirus_names, provirus_predictions
            )
        console.log(f"Provirus classification written to {outputs.provirus_nn_classification_output.name}.")

    if cleanup:
        for cache_dir in (outputs.encoded_sequences_dir, outputs.encoded_proviruses_dir):
            if cache_dir.is_dir():
                shutil.rmtree(cache_dir)
        console.log("Deleted encoded sequence data.")

    console.log("genomad-torch nn-classification finished!", style="yellow")
