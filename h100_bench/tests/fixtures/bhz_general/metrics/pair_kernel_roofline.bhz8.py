"""pair_kernel_roofline: percent of its roofline that the fused complex
H·v kernel reaches over the window's launches."""
from readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "fused_pair_matvec")
