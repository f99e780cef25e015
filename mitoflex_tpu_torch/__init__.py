"""mitoflex_tpu_torch — the MitoFlex pipeline in PyTorch for NVIDIA Hopper.

A port of ``mitoflex_tpu`` (the JAX/TPU package, which stays the reference
the port is tested against). Plain tensor code is PyTorch; the read filter
and the sorted-run merge of the k-mer counter are hand-written CUDA kernels
(``csrc/``), built for sm_90a at first use. The port imports ``torch`` and
never ``jax``; jax-free host modules (FASTQ/FASTA I/O, config, the native
C++ engines, graph cleaning) are imported from ``mitoflex_tpu``, whose
package ``__init__`` imports nothing.

Ported so far: the filter and assemble stages (with local extension and
scaffolding). ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"
