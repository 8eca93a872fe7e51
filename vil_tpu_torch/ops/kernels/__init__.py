"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing these modules builds nothing: the CUDA library is compiled and
loaded by ``build.load()`` at the first launch on a CUDA tensor.
"""
from .full_attention import full_attention_fwd, full_attention_reference
from .vil_attention import mask_to_additive, vil_attention_fwd, vil_attention_reference

# the kernel wrappers of the inference path, each with its launch count
KERNELS = (vil_attention_fwd, full_attention_fwd)

__all__ = [
    "KERNELS",
    "full_attention_fwd",
    "full_attention_reference",
    "mask_to_additive",
    "vil_attention_fwd",
    "vil_attention_reference",
]
