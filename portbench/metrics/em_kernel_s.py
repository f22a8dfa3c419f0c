"""Device seconds a sample spends in the EM kernels of `csrc/em_bucket.cu`
(`em_warp_kernel`, `em_rows_kernel`, `em_strip_kernel`), from the trace."""
from portbench.metrics import kernel_s


def read(run):
    return kernel_s(run, r"\bem_(warp|rows|strip)_kernel")
