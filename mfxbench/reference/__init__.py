"""The plain reference: what the port's outputs are held against.

numpy and plain PyTorch only. Nothing here imports ``mitoflex_tpu_torch``,
``mitoflex_tpu`` or ``jax``; every table it needs (profile scores, filter
decisions, gene places, depths) it works out again from the files and the
truth that the generators made.
"""
