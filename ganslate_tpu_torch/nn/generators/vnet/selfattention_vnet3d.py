"""V-Net 3D with SAGAN self-attention after selected down blocks (the JAX
package's `nn/generators/vnet/selfattention_vnet3d.py`)."""

from dataclasses import dataclass
from typing import Sequence, Tuple

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.vnet.vnet import VnetGenerator


@dataclass
class SelfAttentionVnet3DConfig(configs.base.BaseGeneratorConfig):
    """Partially-invertible V-Net generator with self-attention.

    Attention blocks (SAGAN, arxiv 1805.08318) after selected down blocks
    let distant image regions (e.g. CBCT artifacts) interact beyond the
    convolutions' reach."""
    use_memory_saving: bool = True
    use_inverse: bool = True
    first_layer_channels: int = 16
    down_blocks: Tuple[int] = (1, 2, 3, 2)
    up_blocks: Tuple[int] = (2, 2, 1, 1)
    is_separable: bool = False
    # One flag per down block.
    enable_attention_block: Tuple[bool] = (False, False, True, True)


class SelfAttentionVnet3D(VnetGenerator):
    """`VnetGenerator` in 3D; without `enable_attention_block` every level
    attends, as the JAX class's own default."""

    spatial_dims = 3

    def __init__(self, *args, enable_attention_block: Sequence[bool] = (True, True, True, True),
                 **kwargs):
        super().__init__(*args, enable_attention_block=enable_attention_block, **kwargs)
