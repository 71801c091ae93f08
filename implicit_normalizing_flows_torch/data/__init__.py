from .images import synthetic_structured

__all__ = ["synthetic_structured"]
