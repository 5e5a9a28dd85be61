"""The trainer's mean backward time a step on the card's clock, in ms:
the backward series of `tpu_dra_train_phase_device_seconds`, its sum
over its count (`spans.mean_ms`), over every step of the run the
trainer observed (it leaves out its first, which builds the kernels).
None off the card, where the histogram holds host-clock times, and where
the program has no such family."""

from benchmark.spans import mean_ms


def read(ctx):
    if ctx.run.device.type != "cuda":
        return None
    from tpu_dra_torch.utils import metrics

    hist = getattr(metrics, "TRAIN_PHASE_DEVICE_SECONDS", None)
    return None if hist is None else mean_ms(hist, phase="backward")
