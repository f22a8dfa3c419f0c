"""Device seconds a sample spends in quant prep's kernel of
`csrc/quant_prep.cu` (`prep_tile_kernel`), from the trace."""
from portbench.metrics import kernel_s


def read(run):
    return kernel_s(run, r"\bprep_tile_kernel")
