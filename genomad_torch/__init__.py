"""genomad-torch: the geNomad classification engine in PyTorch for NVIDIA GPUs.

A port of ``genomad_tpu`` (JAX/Pallas for TPUs) to PyTorch with kernels
written by hand for Hopper (CUDA C++ for sm_90a, under ``csrc/``). The JAX
package is the numerical reference; this package imports nothing of it.

Ported so far, the nn-classification branch (IGLOO window classifier):

    FASTA -> 6 kb windows (uint8 base codes) -> IGLOO forward on the card
          -> per-contig mean of window class probabilities

and the annotate branch (gene calling and the marker search):

    FASTA -> genes and proteins (host) -> k-mer prefilter (host, C++)
          -> Smith-Waterman of the candidate pairs on the card (kernel K1)
          -> profile-side gates, best hit per gene -> genes/taxonomy tables

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.5.0"
