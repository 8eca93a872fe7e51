"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing these modules builds nothing: the CUDA library is compiled and
loaded by ``build.load()`` at the first launch on a CUDA tensor.
"""
from .full_attention import (
    FullAttentionFunction,
    full_attention,
    full_attention_bwd,
    full_attention_bwd_reference,
    full_attention_fwd,
    full_attention_reference,
)
from .vil_attention import (
    VilAttentionFunction,
    mask_to_additive,
    vil_attention,
    vil_attention_bwd,
    vil_attention_bwd_reference,
    vil_attention_fwd,
    vil_attention_reference,
)

# every kernel wrapper, each with its launch count: the forwards serve
# inference, all four run in a training step
KERNELS = (vil_attention_fwd, full_attention_fwd, vil_attention_bwd, full_attention_bwd)

__all__ = [
    "KERNELS",
    "FullAttentionFunction",
    "VilAttentionFunction",
    "full_attention",
    "full_attention_bwd",
    "full_attention_bwd_reference",
    "full_attention_fwd",
    "full_attention_reference",
    "mask_to_additive",
    "vil_attention",
    "vil_attention_bwd",
    "vil_attention_bwd_reference",
    "vil_attention_fwd",
    "vil_attention_reference",
]
