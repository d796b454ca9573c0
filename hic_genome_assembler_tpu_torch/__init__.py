"""hic_genome_assembler_tpu_torch: the Hi-C scaffolding pipeline in PyTorch.

The port of ``hic_genome_assembler_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA GPU.  The JAX package stays the reference, and this package
imports nothing of it: it keeps its own copies of the JAX package's
host modules that never touch jax (config, io with its native C++ IO
library, hypergeom, perms, oracle, UPGMA, Louvain, parts 3 and 4, plots,
fixtures) and re-implements the modules that touch the device.  It
imports neither jax nor scikit-learn.

  python -m hic_genome_assembler_tpu_torch -part1 -part2 -part3 -part4 \
      -config <file> -device cuda

Part 1's rank-count scans run through the hand-written CUDA kernel in
``csrc/rank_counts.cu``, and its HMM branch's forward-backward and Viterbi
recursions through those in ``csrc/hmm_scan.cu``; all are built at first
use into ``build/kernels/``.
"""

__version__ = "0.1.0"
