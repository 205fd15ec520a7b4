"""Command-line interface of the port.

Same command set, option names, defaults, and preset semantics as
``genomad_tpu/cli.py`` (reference genomad/cli.py:321-1408):
download-database, the 7 pipeline modules, and end-to-end. Defaults cited
per command; the --conservative/--relaxed presets reject combination with
individual filter flags and inject the preset values (cli.py:250-318).
Every command that computes runs on the card (``run_end_to_end`` and the
modules take ``device``; None is the card and raises without one). Under
torchrun the group callback joins the process group first
(``parallel.mesh.initialize_distributed``), so that the marker search's
default mesh spans every rank (one cell per rank).
"""

from __future__ import annotations

from pathlib import Path

import click

import genomad_torch
from genomad_torch import trace
from genomad_torch.utils import get_n_available_cpus

CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])

# Summary/end-to-end filter options with reference defaults (cli.py:877-967)
_FILTER_DEFAULTS = {
    "min_score": 0.7,
    "max_fdr": 0.1,
    "min_number_genes": 1,
    "min_plasmid_marker_enrichment": 0.1,
    "min_virus_marker_enrichment": 0.0,
    "min_plasmid_hallmarks": 0,
    "min_plasmid_hallmarks_short_seqs": 1,
    "min_virus_hallmarks": 0,
    "min_virus_hallmarks_short_seqs": 1,
    "max_uscg": 4,
}
# presets (cli.py:291-293)
_RELAXED = dict(zip(_FILTER_DEFAULTS, (0, 1.0, 0, -100, -100, 0, 0, 0, 0, 100)))
_CONSERVATIVE = dict(zip(_FILTER_DEFAULTS, (0.8, 0.05, 1, 1.5, 1.5, 1, 1, 1, 1, 2)))


def use_preset(ctx, param, value):
    """--conservative/--relaxed callback (reference: cli.py:250-293)."""
    if value is None:
        return
    if any(
        ctx.get_parameter_source(name) == click.core.ParameterSource.COMMANDLINE
        for name in _FILTER_DEFAULTS
    ):
        raise click.UsageError(
            "You cannot use filtering options (--min-score, --max-fdr, etc.) "
            "together with a preset (--conservative or --relaxed)."
        )
    preset = _CONSERVATIVE if value else _RELAXED
    ctx.params.update(preset)


def filtering_options(fn):
    fn = click.option(
        "--conservative/--relaxed",
        "preset",
        default=None,
        callback=use_preset,
        expose_value=False,
        help="Filtering preset: --conservative for higher precision, "
        "--relaxed to disable all filters.",
    )(fn)
    for name, default in reversed(list(_FILTER_DEFAULTS.items())):
        flag = "--" + name.replace("_", "-")
        # is_eager: filter flags must be parsed before the preset callback
        # runs so the conflict check sees their parameter source
        fn = click.option(
            flag, default=default, show_default=True, is_eager=True,
            type=float if isinstance(default, float) else int,
        )(fn)
    return fn


def common_options(fn):
    fn = click.option("--restart", is_flag=True, default=False, show_default=True, help="Overwrite existing intermediate files.")(fn)
    fn = click.option("--threads", "-t", default=get_n_available_cpus(), show_default=True)(fn)
    fn = click.option("--verbose/--quiet", default=True, show_default=True)(fn)
    return fn


@click.group(context_settings=CONTEXT_SETTINGS)
@click.version_option(version=genomad_torch.__version__, prog_name="genomad-torch")
def cli():
    """genomad-torch: identification of mobile genetic elements on NVIDIA GPUs."""
    # Multi-process runs (torchrun's WORLD_SIZE): join the process group so
    # the marker search's default mesh spans all ranks. A no-op otherwise; the
    # deferred import keeps CLI start-up free of torch.distributed.
    import os

    if "WORLD_SIZE" in os.environ:
        from genomad_torch.parallel import mesh as meshlib

        meshlib.initialize_distributed()


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("destination", type=click.Path(path_type=Path, exists=True))
@click.option("--keep", is_flag=True, default=False, show_default=True, help="Do not delete the compressed database file.")
@click.option("--verbose/--quiet", default=True, show_default=True)
def download_database(destination, keep, verbose):
    """Download the geNomad database to DESTINATION."""
    from genomad_torch.modules import download

    download.main(destination, keep, verbose)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.argument("database", type=click.Path(path_type=Path, exists=True))
@common_options
@click.option("--cleanup", is_flag=True, default=False, show_default=True)
@click.option("--lenient-taxonomy", is_flag=True, default=False, show_default=True)
@click.option("--full-ictv-lineage", is_flag=True, default=False, show_default=True)
@click.option("--sensitivity", "-s", default=4.2, show_default=True)
@click.option("--evalue", "-e", default=1e-3, show_default=True)
@click.option("--splits", default=0, show_default=True, help="No-op: the DB is staged whole on the device.")
@click.option("--use-minimal-db", is_flag=True, default=False, show_default=True)
def annotate(input, output, database, restart, threads, verbose, cleanup, lenient_taxonomy, full_ictv_lineage, sensitivity, evalue, splits, use_minimal_db):
    """Gene calling and marker annotation, the marker search on the GPU."""
    from genomad_torch.modules import annotate as module

    module.main(
        input, output, database, use_minimal_db=use_minimal_db, restart=restart,
        threads=threads, verbose=verbose, lenient_taxonomy=lenient_taxonomy,
        full_ictv_lineage=full_ictv_lineage, sensitivity=sensitivity,
        evalue=evalue, splits=splits, cleanup=cleanup,
    )


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.argument("database", type=click.Path(path_type=Path, exists=True))
@common_options
@click.option("--cleanup", is_flag=True, default=False, show_default=True)
@click.option("--skip-integrase-identification", is_flag=True, default=False, show_default=True)
@click.option("--skip-trna-identification", is_flag=True, default=False, show_default=True)
@click.option("--lenient-taxonomy", is_flag=True, default=False, show_default=True)
@click.option("--full-ictv-lineage", is_flag=True, default=False, show_default=True)
@click.option("--crf-threshold", default=0.4, show_default=True)
@click.option("--marker-threshold", default=12.0, show_default=True)
@click.option("--marker-threshold-integrase", default=8.0, show_default=True)
@click.option("--marker-threshold-edge", default=8.0, show_default=True)
@click.option("--max-integrase-distance", default=10_000, show_default=True)
@click.option("--max-trna-distance", default=5_000, show_default=True)
@click.option("--sensitivity", "-s", default=8.2, show_default=True)
@click.option("--evalue", "-e", default=1e-3, show_default=True)
def find_proviruses(input, output, database, restart, threads, verbose, cleanup, **kwargs):
    """Provirus boundary detection and excision."""
    from genomad_torch.modules import find_proviruses as module

    module.main(input, output, database, cleanup=cleanup, restart=restart, threads=threads, verbose=verbose, **kwargs)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.argument("database", type=click.Path(path_type=Path, exists=True))
@common_options
def marker_classification(input, output, database, restart, threads, verbose):
    """Marker-feature classification (decision forest)."""
    from genomad_torch.modules import marker_classification as module

    module.main(input, output, database, restart=restart, threads=threads, verbose=verbose)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@common_options
@click.option("--cleanup", is_flag=True, default=False, show_default=True)
@click.option("--single-window", is_flag=True, default=False, show_default=True)
@click.option("--batch-size", default=128, show_default=True)
def nn_classification(input, output, restart, threads, verbose, cleanup, single_window, batch_size):
    """Sequence-only NN classification (IGLOO), on the GPU."""
    from genomad_torch.modules import nn_classification as module

    module.main(
        input, output, single_window=single_window, batch_size=batch_size,
        restart=restart, threads=threads, verbose=verbose, cleanup=cleanup,
    )


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--restart", is_flag=True, default=False, show_default=True)
@click.option("--verbose/--quiet", default=True, show_default=True)
def aggregated_classification(input, output, restart, verbose):
    """Fuse marker- and NN-branch scores."""
    from genomad_torch.modules import aggregated_classification as module

    module.main(input, output, restart=restart, verbose=verbose)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--composition", default="auto", show_default=True, type=click.Choice(["auto", "metagenome", "virome"]))
@click.option("--force-auto", is_flag=True, default=False, show_default=True)
@click.option("--verbose/--quiet", default=True, show_default=True)
def score_calibration(input, output, composition, force_auto, verbose):
    """Composition-aware score calibration."""
    from genomad_torch.modules import score_calibration as module

    module.main(input, output, composition=composition, force_auto=force_auto, verbose=verbose)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--verbose/--quiet", default=True, show_default=True)
@filtering_options
def summary(input, output, verbose, **filters):
    """Post-classification filtering and final reports."""
    from genomad_torch.modules import summary as module

    module.main(input, output, verbose=verbose, **filters)


@cli.command(context_settings=CONTEXT_SETTINGS)
@click.argument("input", type=click.Path(path_type=Path, exists=True))
@click.argument("output", type=click.Path(path_type=Path))
@click.argument("database", type=click.Path(path_type=Path, exists=True))
@common_options
@click.option("--cleanup", is_flag=True, default=False, show_default=True)
@click.option("--disable-find-proviruses", is_flag=True, default=False, show_default=True)
@click.option("--disable-nn-classification", is_flag=True, default=False, show_default=True)
@click.option("--enable-score-calibration", is_flag=True, default=False, show_default=True)
@click.option("--lenient-taxonomy", is_flag=True, default=False, show_default=True)
@click.option("--full-ictv-lineage", is_flag=True, default=False, show_default=True)
@click.option("--sensitivity", "-s", default=4.2, show_default=True)
@click.option("--splits", default=0, show_default=True)
@click.option("--skip-integrase-identification", is_flag=True, default=False, show_default=True)
@click.option("--skip-trna-identification", is_flag=True, default=False, show_default=True)
@click.option("--composition", default="auto", show_default=True, type=click.Choice(["auto", "metagenome", "virome"]))
@click.option("--force-auto", is_flag=True, default=False, show_default=True)
@click.option("--single-window", is_flag=True, default=False, show_default=True)
@click.option("--batch-size", default=128, show_default=True)
@filtering_options
def end_to_end(
    input, output, database, restart, threads, verbose, cleanup,
    disable_find_proviruses, disable_nn_classification, enable_score_calibration,
    lenient_taxonomy, full_ictv_lineage, sensitivity, splits,
    skip_integrase_identification, skip_trna_identification,
    composition, force_auto, single_window, batch_size, **filters,
):
    """Run the whole pipeline (reference: cli.py:1256-1408):

    annotate -> find-proviruses -> marker-classification ->
    nn-classification -> aggregated-classification ->
    [score-calibration] -> summary
    """
    run_end_to_end(
        input, output, database, restart=restart, threads=threads,
        verbose=verbose, cleanup=cleanup,
        disable_find_proviruses=disable_find_proviruses,
        disable_nn_classification=disable_nn_classification,
        enable_score_calibration=enable_score_calibration,
        lenient_taxonomy=lenient_taxonomy, full_ictv_lineage=full_ictv_lineage,
        sensitivity=sensitivity, splits=splits,
        skip_integrase_identification=skip_integrase_identification,
        skip_trna_identification=skip_trna_identification,
        composition=composition, force_auto=force_auto,
        single_window=single_window, batch_size=batch_size, **filters,
    )


@trace.spanned("end_to_end")
def run_end_to_end(
    input,
    output,
    database,
    restart=False,
    threads=None,
    verbose=True,
    cleanup=False,
    disable_find_proviruses=False,
    disable_nn_classification=False,
    enable_score_calibration=False,
    lenient_taxonomy=False,
    full_ictv_lineage=False,
    sensitivity=4.2,
    splits=0,
    skip_integrase_identification=False,
    skip_trna_identification=False,
    composition="auto",
    force_auto=False,
    single_window=False,
    batch_size=128,
    device=None,
    mesh=None,
    **filters,
):
    """Programmatic end-to-end pipeline (importable; the CLI wraps this).

    ``device``: where every module computes (None = the card; raises
    without one before anything is written; ``"cpu"`` runs the plain
    PyTorch versions of the kernels). ``mesh``: a ``parallel.mesh.Mesh``
    for the marker and integrase searches and both NN passes, as in the
    JAX package; None leaves each module on ``device``, and with neither
    given the marker search takes ``annotate.default_search_mesh()``.

    While a ``torch.profiler`` session records, the run is one job of the
    port's spans (``genomad_torch.trace``): ``end_to_end``, with each
    module's ``module.<name>`` inside it, on the threads they run on."""
    from genomad_torch.modules import (
        aggregated_classification as agg_mod,
        annotate as annotate_mod,
        find_proviruses as fp_mod,
        marker_classification as marker_mod,
        nn_classification as nn_mod,
        score_calibration as cal_mod,
        summary as summary_mod,
    )

    from genomad_torch.device import resolve_device

    resolve_device(device)  # raises without a card, before anything is written
    filters = {**_FILTER_DEFAULTS, **filters}

    def _annotate():
        annotate_mod.main(
            input, output, database, restart=restart, threads=threads,
            verbose=verbose, lenient_taxonomy=lenient_taxonomy,
            full_ictv_lineage=full_ictv_lineage, sensitivity=sensitivity,
            splits=splits, cleanup=cleanup, device=device, mesh=mesh,
        )

    if disable_nn_classification:
        _annotate()
    else:
        # Stage overlap: the NN contig pass is device-bound while
        # annotate's marker search is host-prefilter-bound — the two are
        # independent until aggregation, so they run CONCURRENTLY (annotate
        # on a worker thread; both share the card) instead of the
        # reference's sequential chain. The NN provirus second pass needs
        # find-proviruses output; a second nn-classification call below
        # reuses the cached contig results (skip/resume machinery) and runs
        # only that pass.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(trace.carry(_annotate))
            nn_mod.main(
                input, output, single_window=single_window,
                batch_size=batch_size, restart=restart, threads=threads,
                verbose=verbose, cleanup=False, device=device, mesh=mesh,
                skip_proviruses=True,
            )
            fut.result()
    if not disable_find_proviruses:
        fp_mod.main(
            input, output, database, cleanup=cleanup, restart=restart,
            skip_integrase_identification=skip_integrase_identification,
            skip_trna_identification=skip_trna_identification,
            threads=threads, verbose=verbose,
            lenient_taxonomy=lenient_taxonomy,
            full_ictv_lineage=full_ictv_lineage, device=device, mesh=mesh,
        )
    marker_mod.main(input, output, database, restart=restart, threads=threads, verbose=verbose, device=device)
    if not disable_nn_classification:
        # second pass: contig classification is cached from the overlapped
        # run; only the provirus windows (post find-proviruses) compute here
        nn_mod.main(
            input, output, single_window=single_window, batch_size=batch_size,
            restart=False, threads=threads, verbose=verbose,
            cleanup=cleanup, device=device, mesh=mesh,
        )
        agg_mod.main(input, output, restart=restart, verbose=verbose)
    if enable_score_calibration:
        cal_mod.main(input, output, composition=composition, force_auto=force_auto, verbose=verbose)
    summary_mod.main(input, output, verbose=verbose, **filters)


if __name__ == "__main__":
    cli()
