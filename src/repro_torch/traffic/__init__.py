# Model traffic as link streams (counterpart of repro.traffic).  Only the
# int8 wire view is ported so far; the ordering integration points and the
# stream reports are a later slice.
from .ordering import int8_view

__all__ = ["int8_view"]
