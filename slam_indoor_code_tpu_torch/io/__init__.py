"""Host-side IO: reference-format txt logs, OpenCV-XML calibration files,
photo-glob media (native decoding, or the port's own readers of JPEG,
PNG, BMP, Netpbm, TIFF and lossy WebP with EXIF orientation), video (AVI,
MP4/QuickTime, Matroska/WebM, MPEG program and transport streams;
Motion-JPEG, MPEG-4 Part 2, MPEG-1/2, VP8, VP9 and uncompressed
I420/Y800 decoded without OpenCV or FFmpeg) and the in-memory frame
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
