from .field import FlowField
from .grid import Grid
from .status import CFDError, Status

__all__ = ["FlowField", "Grid", "CFDError", "Status"]
