"""real_kernel_roofline: percent of its roofline that the fused real H·v
kernel reaches over the window's launches (sum of bounds over sum of
device times)."""
from readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "fused_real_matvec")
