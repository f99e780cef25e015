"""V2, nhmmer's pass 2 with envelopes (``ops/phmm.viterbi_scan``)."""

from . import viterbi

OP = ("mitoflex_tpu_torch.ops.phmm", "viterbi_scan")


def record(args, kwargs, out) -> dict:
    prof, seqs, lengths, model_len = args[:4]
    band = args[4] if len(args) > 4 else kwargs.get("delete_band", 16)
    return viterbi.record(OP[1], prof, [model_len], seqs, lengths, band)


bound = viterbi.bound
