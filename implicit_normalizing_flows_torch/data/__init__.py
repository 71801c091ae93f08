from .images import synthetic_structured
from .tabular import (TABULAR_DIMS, batch_iterator, get_power_raw, get_tabular_datasets,
                      synthetic_tabular)

__all__ = ["synthetic_structured", "TABULAR_DIMS", "batch_iterator", "get_power_raw",
           "get_tabular_datasets", "synthetic_tabular"]
