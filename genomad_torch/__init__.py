"""genomad-torch: the geNomad classification engine in PyTorch for NVIDIA GPUs.

A port of ``genomad_tpu`` (JAX/Pallas for TPUs) to PyTorch with kernels
written by hand for Hopper (CUDA C++ for sm_90a, under ``csrc/``). The JAX
package is the numerical reference; this package imports nothing of it.

Every command of ``genomad_tpu`` is ported; ``end-to-end`` runs FASTA to
the virus and plasmid summaries:

    FASTA -> annotate: genes and proteins (host) -> k-mer prefilter (host,
             C++) -> Smith-Waterman of the candidate pairs on the card (K1)
          || nn-classification: 6 kb windows -> IGLOO forward on the card
             (K5, K4, K2) -> per-contig mean of window class probabilities
          -> find-proviruses: CRF on the card, integrase search (K1),
             tRNA scan (host) -> marker-classification: decision forest on
             the card -> the NN provirus pass -> aggregated-classification
          -> [score-calibration] -> summary

The forward profiler (``genomad_torch.tools.profile_forward``) also runs
K3, the patch reduction without the value projection.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel is replaced by its plain PyTorch version.

Native code is built at first use through ``genomad_torch.build_dir``: the
kernels with ``nvcc``, and the k-mer prefilter, a C++ library
(``native/prefilter.cpp``) and the only prefilter, with a host C++
compiler. A build that fails raises with the compiler's output; there is no
slower path to fall back to. The JAX package's
``genomad_tpu/ops/protein_search.py`` states the prefilter's algorithm in
NumPy (``prefilter_query``).
"""

__version__ = "0.5.0"
