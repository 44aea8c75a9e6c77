"""OpenCV FileStorage XML interop for calibration matrices (the port's own
copy of the JAX package's io/xmlio.py, which imports no JAX: the port
imports nothing of that package).

The reference persists camera intrinsics as OpenCV-XML: a 3×3 ``K`` matrix,
1×5 distortion coefficients ``DC``, and per-view ``R``/``T`` blocks
(reference: src/misc/IOmisc.cpp:53-86 ``saveMatrixToXML`` /
``loadMatrixFromXML``; 17 device profiles ship under ``config/*.xml``).
We read and write that exact format without OpenCV so the reference's
calibration files work unchanged.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

_DT_TO_DTYPE = {"d": np.float64, "f": np.float32, "i": np.int32, "u": np.uint8}


def _parse_matrix(node: ET.Element) -> np.ndarray:
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    dt = (node.findtext("dt") or "d").strip().strip('"')
    # dt may be a multi-channel spec like "3d" — channels fold into columns.
    m = re.fullmatch(r"(\d*)([dfiu])", dt)
    channels = int(m.group(1)) if m and m.group(1) else 1
    dtype = _DT_TO_DTYPE.get(m.group(2) if m else "d", np.float64)
    data = np.array((node.findtext("data") or "").split(), dtype=np.float64)
    out = data.astype(dtype).reshape(rows, cols * channels)
    return out


def load_matrix_from_xml(path: str, key: str = "K") -> np.ndarray:
    """Load the matrix stored under tag ``key`` (reference:
    ``loadMatrixFromXML``, src/misc/IOmisc.cpp:78-86)."""
    with open(path) as f:
        text = f.read()
    # OpenCV writes literal "<!-- resumed -->" markers between appends and may
    # produce multiple top-level elements; wrap for well-formedness.
    text = re.sub(r"<\?xml[^>]*\?>", "", text)
    text = re.sub(r"<!--.*?-->", "", text, flags=re.S)
    if "<opencv_storage>" not in text:
        text = f"<opencv_storage>{text}</opencv_storage>"
    else:
        # Appended FileStorage sessions each emit their own root; merge them.
        text = text.replace("</opencv_storage>", "").replace("<opencv_storage>", "")
        text = f"<opencv_storage>{text}</opencv_storage>"
    root = ET.fromstring(text)
    node = root.find(key)
    if node is None:
        raise KeyError(f"Matrix '{key}' not found in {path}")
    return _parse_matrix(node)


def _matrix_xml(matrix: np.ndarray, key: str) -> str:
    m = np.asarray(matrix, dtype=np.float64)
    if m.ndim == 1:
        m = m[None, :]
    vals = " ".join(f"{v:.16e}" for v in m.ravel())
    return (
        f'<{key} type_id="opencv-matrix">\n'
        f"  <rows>{m.shape[0]}</rows>\n"
        f"  <cols>{m.shape[1]}</cols>\n"
        f"  <dt>d</dt>\n"
        f"  <data>\n    {vals}</data></{key}>\n"
    )


def save_matrix_to_xml(path: str, matrix: np.ndarray, key: str = "K", mode: str = "w") -> None:
    """Save a matrix under tag ``key``; ``mode='a'`` appends a block like
    OpenCV's FileStorage::APPEND (reference: src/misc/IOmisc.cpp:53-66)."""
    block = _matrix_xml(matrix, key)
    if mode == "a" and os.path.exists(path):
        with open(path) as f:
            text = f.read()
        text = text.replace("</opencv_storage>", block + "</opencv_storage>")
        with open(path, "w") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n<opencv_storage>\n')
            f.write(block)
            f.write("</opencv_storage>\n")


def save_calib_parameters_to_xml(
    path: str,
    camera_matrix: np.ndarray,
    distortion_coeffs: np.ndarray,
    rvecs: np.ndarray,
    tvecs: np.ndarray,
) -> None:
    """Persist K, DC, and per-view R/T like the reference's
    ``saveCalibParametersToXML`` (src/misc/IOmisc.cpp:68-76)."""
    save_matrix_to_xml(path, camera_matrix, "K", "w")
    save_matrix_to_xml(path, np.asarray(distortion_coeffs).reshape(1, -1), "DC", "a")
    save_matrix_to_xml(path, np.asarray(rvecs).reshape(-1, 3), "R", "a")
    save_matrix_to_xml(path, np.asarray(tvecs).reshape(-1, 3), "T", "a")
