"""Chessboard intrinsics calibration (Zhang closed form + LM refine)."""

from .chessboard import (
    calibrate_camera,
    chessboard_photos_calibration,
    find_chessboard_corners,
    main_calibration_entry_point,
    make_object_points,
)

__all__ = [
    "calibrate_camera",
    "chessboard_photos_calibration",
    "find_chessboard_corners",
    "main_calibration_entry_point",
    "make_object_points",
]
