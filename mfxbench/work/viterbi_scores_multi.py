"""V1, nhmmer's pass 1 (``ops/phmm.viterbi_scores_multi``)."""

from . import viterbi

OP = ("mitoflex_tpu_torch.ops.phmm", "viterbi_scores_multi")


def record(args, kwargs, out) -> dict:
    profs, model_lens, seqs, lengths = args[:4]
    band = args[4] if len(args) > 4 else kwargs.get("delete_band", 16)
    return viterbi.record(OP[1], profs, model_lens, seqs, lengths, band)


bound = viterbi.bound
