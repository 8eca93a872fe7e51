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
from .layer_norm import (
    LayerNormFunction,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
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
from .vil_attention_halo import (
    VilAttentionHaloFunction,
    vil_attention_halo,
    vil_attention_halo_bwd,
    vil_attention_halo_bwd_reference,
    vil_attention_halo_fwd,
    vil_attention_halo_reference,
)
from .vil_block import (
    VilBlockFunction,
    vil_block,
    vil_block_bwd,
    vil_block_bwd_reference,
    vil_block_fwd,
    vil_block_fwd_reference,
    vil_block_reference,
)
from .vil_mode_attention import (
    VilModeAttentionFunction,
    vil_mode_attention,
    vil_mode_attention_bwd,
    vil_mode_attention_bwd_reference,
    vil_mode_attention_fwd,
    vil_mode_attention_reference,
    vil_self_attention_bwd,
    vil_self_attention_fwd,
)
from .vil_mode_attention_halo import (
    VilModeAttentionHaloFunction,
    vil_mode_attention_halo,
    vil_mode_attention_halo_bwd,
    vil_mode_attention_halo_bwd_reference,
    vil_mode_attention_halo_fwd,
    vil_mode_attention_halo_reference,
)

# every kernel wrapper, each with its launch count: the first two forwards
# serve inference, the first four run in a MODE-0 training step, the
# sampled-neighbour pair takes the sliding-chunk pair's place in a
# random-shift (MODE > 0) training step, and in the fused-kernel
# configuration the LayerNorm pair runs in the block pre-norms and the fused
# block pair in the sliding-chunk pair's place; under spatial (chunk-row)
# parallelism the halo-input pair takes it; at mode -1 (the self chunk
# alone) the self-only pair, the sampled-neighbour kernels' instance over one
# chunk; in random-shift training under the split the sampled-neighbour
# pair's halo form
KERNELS = (vil_attention_fwd, full_attention_fwd, vil_attention_bwd, full_attention_bwd,
           vil_mode_attention_fwd, vil_mode_attention_bwd, layer_norm_fwd, layer_norm_bwd,
           vil_block_fwd, vil_block_bwd, vil_attention_halo_fwd, vil_attention_halo_bwd,
           vil_self_attention_fwd, vil_self_attention_bwd, vil_mode_attention_halo_fwd,
           vil_mode_attention_halo_bwd)

__all__ = [
    "KERNELS",
    "FullAttentionFunction",
    "LayerNormFunction",
    "VilAttentionFunction",
    "VilAttentionHaloFunction",
    "VilBlockFunction",
    "VilModeAttentionFunction",
    "VilModeAttentionHaloFunction",
    "full_attention",
    "full_attention_bwd",
    "full_attention_bwd_reference",
    "full_attention_fwd",
    "full_attention_reference",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "layer_norm_fwd",
    "layer_norm_reference",
    "mask_to_additive",
    "vil_attention",
    "vil_attention_bwd",
    "vil_attention_bwd_reference",
    "vil_attention_fwd",
    "vil_attention_halo",
    "vil_attention_halo_bwd",
    "vil_attention_halo_bwd_reference",
    "vil_attention_halo_fwd",
    "vil_attention_halo_reference",
    "vil_attention_reference",
    "vil_block",
    "vil_block_bwd",
    "vil_block_bwd_reference",
    "vil_block_fwd",
    "vil_block_fwd_reference",
    "vil_block_reference",
    "vil_mode_attention",
    "vil_mode_attention_bwd",
    "vil_mode_attention_bwd_reference",
    "vil_mode_attention_fwd",
    "vil_mode_attention_halo",
    "vil_mode_attention_halo_bwd",
    "vil_mode_attention_halo_bwd_reference",
    "vil_mode_attention_halo_fwd",
    "vil_mode_attention_halo_reference",
    "vil_mode_attention_reference",
    "vil_self_attention_bwd",
    "vil_self_attention_fwd",
]
