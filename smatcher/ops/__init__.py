from smatcher.ops import numpy_ref

__all__ = ["numpy_ref"]
