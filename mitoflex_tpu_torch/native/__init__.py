"""Native host runtime (C++).

Compiled lazily by ``g++`` into ``mitoflex_tpu_torch/_build/`` on first use
(``fastq_native.build``); every consumer has a pure-Python fallback, so a
missing toolchain degrades performance, not functionality."""
