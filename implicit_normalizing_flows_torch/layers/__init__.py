from .actnorm import ActNorm2d
from .activations import Swish
from .container import SequentialFlow
from .elemwise import LogitTransform
from .implicit_block import ImplicitBlock
from .lipschitz import InducedNormConv
from .nets import LipschitzNet
from .protocol import Flow, make_vars
from .squeeze import SqueezeLayer

__all__ = ["ActNorm2d", "Swish", "SequentialFlow", "LogitTransform",
           "ImplicitBlock", "InducedNormConv", "LipschitzNet", "Flow",
           "make_vars", "SqueezeLayer"]
