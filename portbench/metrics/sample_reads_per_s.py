"""The reads of the window's samples that ran without the profiler, over
the sum of their walls: a resident process's throughput, read in a traced
run on the samples between the traced ones."""


def read(run):
    done = [s for s in run.samples if s.ok and not s.traced]
    wall = sum(s.wall_s for s in done)
    if not done or wall <= 0:
        return None
    return sum(s.reads for s in done) / wall
