"""Device launches (kernels, copies, sets) in the window per real audio
second converted: the contour loops issue about ten per frame step."""

from benchmark.readers import per_count


def read(run):
    return per_count(run, "audio_s")
