"""Host-side IO: reference-format txt logs, OpenCV-XML calibration files and
the in-memory frame source.  (File-path media is not part of this port
yet.)"""

from .logs import (
    GlobalData,
    LogStreams,
    format_matrix,
    load_global_data_from_logs,
    write_matrix,
)
from .media import ArraySource
from .xmlio import (
    load_matrix_from_xml,
    save_calib_parameters_to_xml,
    save_matrix_to_xml,
)

__all__ = [
    "ArraySource",
    "GlobalData",
    "LogStreams",
    "format_matrix",
    "load_global_data_from_logs",
    "load_matrix_from_xml",
    "save_calib_parameters_to_xml",
    "save_matrix_to_xml",
    "write_matrix",
]
