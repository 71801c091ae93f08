from .actnorm import ActNorm2d
from .activations import Sin, Swish
from .container import SequentialFlow
from .elemwise import LogitTransform
from .implicit_block import ImplicitBlock
from .lipschitz import InducedNormConv, InducedNormDense, get_dense
from .nets import LipschitzNet
from .protocol import Flow, make_vars
from .squeeze import SqueezeLayer

__all__ = ["ActNorm2d", "Sin", "Swish", "SequentialFlow", "LogitTransform",
           "ImplicitBlock", "InducedNormConv", "InducedNormDense", "get_dense",
           "LipschitzNet", "Flow", "make_vars", "SqueezeLayer"]
