"""The share of the traced window in which no kernel, copy or memset ran on
the card, in percent."""


def read(run):
    tr = [s.trace for s in run.samples if s.trace]
    span = sum(t["span_s"] for t in tr)
    if not tr or span <= 0:
        return None
    return 100.0 * (1.0 - sum(t["busy_s"] for t in tr) / span)
