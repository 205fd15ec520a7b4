"""``python -m genomad_torch`` entry point."""

from genomad_torch.cli import cli

if __name__ == "__main__":
    cli()
