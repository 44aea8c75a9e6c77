"""Host-side IO: reference-format txt logs and the in-memory frame source.
(File-path media and OpenCV-XML calibration are not part of this port yet.)"""

from .logs import (
    GlobalData,
    LogStreams,
    format_matrix,
    load_global_data_from_logs,
    write_matrix,
)
from .media import ArraySource

__all__ = [
    "ArraySource",
    "GlobalData",
    "LogStreams",
    "format_matrix",
    "load_global_data_from_logs",
    "write_matrix",
]
