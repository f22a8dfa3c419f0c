"""Seconds from the harness's start to the window's: the seed's set made
in a child, the port imported, two warm-up samples and one of the sample
BAM."""


def read(run):
    return run.setup_s
