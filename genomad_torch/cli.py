"""Command-line interface of the port.

Same option names and defaults as ``genomad_tpu/cli.py`` (reference
genomad/cli.py:321-1408). ``annotate`` and ``nn-classification`` are
ported so far; the other commands follow with their modules.
"""

from __future__ import annotations

from pathlib import Path

import click

import genomad_torch
from genomad_torch.utils import get_n_available_cpus

CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])


def common_options(fn):
    fn = click.option("--restart", is_flag=True, default=False, show_default=True, help="Overwrite existing intermediate files.")(fn)
    fn = click.option("--threads", "-t", default=get_n_available_cpus(), show_default=True)(fn)
    fn = click.option("--verbose/--quiet", default=True, show_default=True)(fn)
    return fn


@click.group(context_settings=CONTEXT_SETTINGS)
@click.version_option(version=genomad_torch.__version__, prog_name="genomad-torch")
def cli():
    """genomad-torch: identification of mobile genetic elements on NVIDIA GPUs."""


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


if __name__ == "__main__":
    cli()
