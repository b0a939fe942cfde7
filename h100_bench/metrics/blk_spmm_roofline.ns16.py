"""blk_spmm_roofline: percent of its roofline that the block-sparse SpMM
reaches over the window's launches (sum of bounds over sum of device
times)."""
from readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "blk_spmm")
