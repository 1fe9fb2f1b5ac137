"""The whole step's operations over the window times the bf16 dense peak,
in a cell whose converter vocodes with Parallel WaveGAN: the model's
operations of the real frames converted (``flops.py``, as
``mfu_pct.corpus``) plus the vocoder's for the real samples converted
(``flops_pwg.py``: the audio seconds times the rate times its operations
per sample).  Model and vocoder serve in bf16.  None where the
configuration has no vocoder or the trace no device time."""

from benchmark import flops, flops_pwg, peaks, readers


def read(run):
    voc = run.config.get("vocoder")
    if voc is None:
        return None
    arch = readers.architecture(run.config, "serve_dtype")
    ops = (run.counters.get("frames", 0) * flops.generator_per_frame(arch)
           + run.counters.get("audio_s", 0) * run.config["world"]["fs"]
           * flops_pwg.per_sample(voc))
    return readers.mfu(run, ops, peaks.BF16_OPS_PER_S)
