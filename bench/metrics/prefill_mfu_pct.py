"""The prefill calls' model flops (``flops/<family>.py``, from the
configuration and the batches' shapes) over the seconds in prefill (the
``prefill_tok_s`` spans of the measured window) times the bf16 tensor-core peak
(``roofline/peaks.py``), in percent."""
from bench.roofline import peaks


def read(rec):
    flops = sum(rec.flops.prefill_flops(rec.run, b["batch"], b["length"])
                for b in rec.batches)
    seconds = sum(b["t_first"] - b["t_start"] for b in rec.batches)
    return 100.0 * flops / (seconds * peaks.MATMUL_OPS_PER_S[
        rec.run["compute_dtype"]])
