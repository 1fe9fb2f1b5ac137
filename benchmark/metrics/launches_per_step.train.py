"""Device launches (kernels, copies, sets) in the window per VAW-GAN
step completed."""

from benchmark.readers import per_count


def read(run):
    return per_count(run, "steps")
