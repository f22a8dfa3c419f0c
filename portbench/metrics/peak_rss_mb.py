"""The highest resident set of the process that runs the port (the
harness's own, ru_maxrss), in MB of 10^6 bytes, read when the window
closes."""


def read(run):
    return run.peak_rss_bytes / 1e6 if run.peak_rss_bytes else None
