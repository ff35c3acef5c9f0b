"""descent_dev_ms: the program's ``probe.descent.device`` spans, the
device twin of the stacked probe's dense descent and group level
(``dist/probe.py::StackedProbe._device_masks``): the stream's time from
reaching the descent's first queued operation to finishing its last
(CUDA events), their sum a batch, the mean over the window's batches that
have them.  Nothing off the card or where no batch has the span."""


def read(rec):
    got = [s["probe.descent.device"] for s in rec.stage_s if "probe.descent.device" in s]
    return sum(got) / len(got) * 1e3 if got else None
