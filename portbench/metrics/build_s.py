"""build_s: ``GnnPeEngine.build`` on the host clock, ending in a
synchronize: partition, train (or check) the encoders, embed, enumerate
and index the paths, stack them for the stacked probe."""


def read(rec):
    return rec.build_s
