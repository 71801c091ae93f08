from .implicit_flow import ImplicitFlow, StackedImplicitBlocks, build_conv_net

__all__ = ["ImplicitFlow", "StackedImplicitBlocks", "build_conv_net"]
