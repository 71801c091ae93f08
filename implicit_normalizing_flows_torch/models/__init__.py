from .builders import build_lipschitz_mlp, build_tabular_model, parse_vnorms
from .implicit_flow import ImplicitFlow, StackedImplicitBlocks, build_conv_net

__all__ = ["ImplicitFlow", "StackedImplicitBlocks", "build_conv_net",
           "build_lipschitz_mlp", "build_tabular_model", "parse_vnorms"]
