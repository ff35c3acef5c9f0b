"""probe_dev_ms: the program's ``probe.device`` span, the device twin of
the ``probe`` stage (under the hand-off, ``StackedProbe.probe_device``):
the stream's time from reaching the stage's first queued operation to
finishing its last (CUDA events), its mean over the window's batches that
have it.  Unlike the host span it holds the probe's device work that ends
after the host has left the stage.  Nothing off the card or where no
batch has the span."""


def read(rec):
    got = [s["probe.device"] for s in rec.stage_s if "probe.device" in s]
    return sum(got) / len(got) * 1e3 if got else None
