"""Networks of the style-transfer render and of blind estimation, as
``torch.nn`` modules, and the flax weight converters. PyTorch counterpart of
``dasp_tpu/models``."""

from .convert import parameter_network_from_flax, style_net_from_flax
from .style import StyleTransferNet, apply_style_chain, make_style_processors
from .tcn import Encoder, ParameterNetwork, ParameterProjector, TCNBlock

__all__ = [
    "TCNBlock",
    "ParameterNetwork",
    "Encoder",
    "ParameterProjector",
    "StyleTransferNet",
    "apply_style_chain",
    "make_style_processors",
    "style_net_from_flax",
    "parameter_network_from_flax",
]
