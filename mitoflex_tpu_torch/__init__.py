"""mitoflex_tpu_torch — the MitoFlex pipeline in PyTorch for NVIDIA Hopper.

A port of ``mitoflex_tpu`` (the JAX/TPU package, which stays the reference
the port is tested against). Plain tensor code is PyTorch; the read filter,
the sorted-run merges of the k-mer counter and the graph pass, and the
2-word key sort are hand-written CUDA kernels (``csrc/``), built for sm_90a
at first use. The port imports ``torch``, never ``jax`` and nothing of
``mitoflex_tpu``: it keeps its own copies of the host modules (FASTQ/FASTA
I/O, config, the native C++ engines, graph cleaning, profile models), and
builds its own native host library into ``_build/``.

All five stages are ported (filter, assemble with local extension and
scaffolding, findmitoscaf, annotate, visualize) with ``run_all``, ``run_bim``
and the whole command line; multi-device runs are what remains (ROADMAP.md).
"""

__version__ = "0.1.0"
