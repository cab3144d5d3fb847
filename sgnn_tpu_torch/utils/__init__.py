from .io import read_binary
from .logging import get_logger

__all__ = ["get_logger", "read_binary"]
