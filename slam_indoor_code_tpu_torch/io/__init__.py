"""Host-side IO: reference-format txt logs, OpenCV-XML calibration files,
photo-glob media (native or numpy decoding) and the in-memory frame
source."""

from .logs import (
    GlobalData,
    LogStreams,
    format_matrix,
    load_global_data_from_logs,
    write_matrix,
)
from .media import ArraySource, MediaSource, natural_sort_paths
from .xmlio import (
    load_matrix_from_xml,
    save_calib_parameters_to_xml,
    save_matrix_to_xml,
)

__all__ = [
    "ArraySource",
    "GlobalData",
    "LogStreams",
    "MediaSource",
    "format_matrix",
    "load_global_data_from_logs",
    "load_matrix_from_xml",
    "natural_sort_paths",
    "save_calib_parameters_to_xml",
    "save_matrix_to_xml",
    "write_matrix",
]
