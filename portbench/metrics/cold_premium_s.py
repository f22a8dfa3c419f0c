"""The first warm-up sample's wall in set-up less the second's: the
process's first `import torch`, CUDA start-up, kernel loads and the
annotation's index. Both warm-ups run untraced in every run."""


def read(run):
    if len(run.warmup_walls) < 2:
        return None
    return run.warmup_walls[0] - run.warmup_walls[1]
