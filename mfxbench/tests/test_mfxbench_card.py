"""What only the card can show, at test sizes: the profiler's trace of real
kernels reduces to a busy time and op device times, and the reference's
Viterbi gives the same scores on the card as on the CPU. Run on the card:
``python3 -m pytest mfxbench/tests -m card``."""

import numpy as np
import pytest
import torch

from mfxbench import devtrace
from mfxbench.generators import hmm_text, mitogenome
from mfxbench.reference import hmm as ref_hmm
from mfxbench.reference import viterbi as ref_viterbi


@pytest.mark.card
def test_mfxbench_trace_on_card(cuda_card, tmp_path):
    from torch.profiler import record_function

    x = torch.randn(4096, 4096, device=cuda_card)

    def work(_):
        with record_function("mfx.stage.filter"):
            with record_function("mfx.op.sort_words2#0"):
                y = x @ x
            torch.cuda.synchronize()
            with record_function("mfx.op.sort_words2#1"):
                z = torch.sort(y.flatten())[0]
            z.sum().item()

    r = devtrace.trace_sample(None, work, str(tmp_path))
    assert 0 < r["busy_s"] < r["window_s"]
    assert set(r["op_device_ms"]) == {0, 1} and min(r["op_device_ms"].values()) > 0
    assert r["device_ops"] and r["idle_gaps"]


@pytest.mark.card
def test_mfxbench_reference_viterbi_on_card(cuda_card):
    rng = np.random.default_rng(9)
    cons = mitogenome.random_dna(rng, 300)
    model = ref_hmm.parse(hmm_text.hmm_text([hmm_text.profile_from_consensus("m", cons)]))["m"]
    codes = rng.integers(0, 4, (4, 700))
    codes[0, 100:400] = ["ACGT".index(c) for c in cons]
    lengths = np.array([700, 600, 500, 20])
    cpu = ref_viterbi.scores(model, codes, lengths)
    card = ref_viterbi.scores(model, codes, lengths, device=cuda_card)
    assert np.abs(cpu - card).max() < 1e-9
