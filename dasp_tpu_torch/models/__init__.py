"""Networks of the style-transfer render, as ``torch.nn`` modules, and the
flax weight converter. PyTorch counterpart of ``dasp_tpu/models``."""

from .convert import style_net_from_flax
from .style import StyleTransferNet, apply_style_chain, make_style_processors
from .tcn import Encoder, ParameterProjector, TCNBlock

__all__ = [
    "TCNBlock",
    "Encoder",
    "ParameterProjector",
    "StyleTransferNet",
    "apply_style_chain",
    "make_style_processors",
    "style_net_from_flax",
]
