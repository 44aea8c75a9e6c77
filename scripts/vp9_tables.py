"""Write slam_indoor_code_tpu_torch/native/vp9_tables.h: the constant
tables of the VP9 decoder (native/vp9.cpp), taken by symbol name from the
libvpx that OpenCV's wheel carries, under libvpx's BSD notice.

The library's ``.symtab`` is read here in pure Python (ELF64, little
endian; no ``readelf``, no cv2 import): each wanted symbol is looked up by
name, inside the compilation unit (the ``STT_FILE`` symbol before it) that
defines it where two units use the same name (``dc_qlookup`` is VP8's and
VP9's), and its bytes are read from the section that holds it.  The tables
libvpx folds into code (the default skip, transform-size, reference and
motion-vector probabilities) have no symbol; vp9.cpp writes those out
itself.

    python scripts/vp9_tables.py [--lib PATH] [--check]

``--check`` compares the committed header with what would be written and
exits 1 when they differ.  The header is committed: the card builds from
it alone.
"""

import argparse
import glob
import os
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "slam_indoor_code_tpu_torch", "native",
                      "vp9_tables.h")

# (symbol, defining file or None, C element type, dimensions)
TABLES = [
    ("vp9_pareto8_full", None, "uint8_t", (255, 8)),
    ("vp9_kf_y_mode_prob", None, "uint8_t", (10, 10, 9)),
    ("vp9_kf_uv_mode_prob", None, "uint8_t", (10, 9)),
    ("vp9_kf_partition_probs", None, "uint8_t", (16, 3)),
    ("default_coef_probs_4x4", "vp9_entropy.c", "uint8_t", (2, 2, 6, 6, 3)),
    ("default_coef_probs_8x8", "vp9_entropy.c", "uint8_t", (2, 2, 6, 6, 3)),
    ("default_coef_probs_16x16", "vp9_entropy.c", "uint8_t",
     (2, 2, 6, 6, 3)),
    ("default_coef_probs_32x32", "vp9_entropy.c", "uint8_t",
     (2, 2, 6, 6, 3)),
    ("default_if_y_probs", "vp9_entropymode.c", "uint8_t", (4, 9)),
    ("default_if_uv_probs", "vp9_entropymode.c", "uint8_t", (10, 9)),
    ("default_partition_probs", "vp9_entropymode.c", "uint8_t", (16, 3)),
    ("default_inter_mode_probs", "vp9_entropymode.c", "uint8_t", (7, 3)),
    ("default_single_ref_p", "vp9_entropymode.c", "uint8_t", (5, 2)),
    ("default_switchable_interp_prob", "vp9_entropymode.c", "uint8_t",
     (4, 2)),
    ("count_to_update_factor", "vp9_entropymode.c", "int32_t", (21,)),
    ("default_scan_4x4", "vp9_scan.c", "int16_t", (16,)),
    ("col_scan_4x4", "vp9_scan.c", "int16_t", (16,)),
    ("row_scan_4x4", "vp9_scan.c", "int16_t", (16,)),
    ("default_scan_8x8", "vp9_scan.c", "int16_t", (64,)),
    ("col_scan_8x8", "vp9_scan.c", "int16_t", (64,)),
    ("row_scan_8x8", "vp9_scan.c", "int16_t", (64,)),
    ("default_scan_16x16", "vp9_scan.c", "int16_t", (256,)),
    ("col_scan_16x16", "vp9_scan.c", "int16_t", (256,)),
    ("row_scan_16x16", "vp9_scan.c", "int16_t", (256,)),
    ("default_scan_32x32", "vp9_scan.c", "int16_t", (1024,)),
    ("default_scan_4x4_neighbors", "vp9_scan.c", "int16_t", (34,)),
    ("col_scan_4x4_neighbors", "vp9_scan.c", "int16_t", (34,)),
    ("row_scan_4x4_neighbors", "vp9_scan.c", "int16_t", (34,)),
    ("default_scan_8x8_neighbors", "vp9_scan.c", "int16_t", (130,)),
    ("col_scan_8x8_neighbors", "vp9_scan.c", "int16_t", (130,)),
    ("row_scan_8x8_neighbors", "vp9_scan.c", "int16_t", (130,)),
    ("default_scan_16x16_neighbors", "vp9_scan.c", "int16_t", (514,)),
    ("col_scan_16x16_neighbors", "vp9_scan.c", "int16_t", (514,)),
    ("row_scan_16x16_neighbors", "vp9_scan.c", "int16_t", (514,)),
    ("default_scan_32x32_neighbors", "vp9_scan.c", "int16_t", (2050,)),
    ("vp9_coefband_trans_4x4", None, "uint8_t", (16,)),
    ("vp9_coefband_trans_8x8plus", None, "uint8_t", (1024,)),
    ("vp9_cat1_prob", None, "uint8_t", (1,)),
    ("vp9_cat2_prob", None, "uint8_t", (2,)),
    ("vp9_cat3_prob", None, "uint8_t", (3,)),
    ("vp9_cat4_prob", None, "uint8_t", (4,)),
    ("vp9_cat5_prob", None, "uint8_t", (5,)),
    ("vp9_cat6_prob", None, "uint8_t", (14,)),
    ("dc_qlookup", "vp9_quant_common.c", "int16_t", (256,)),
    ("ac_qlookup", "vp9_quant_common.c", "int16_t", (256,)),
    ("sub_pel_filters_8", "vp9_filter.c", "int16_t", (16, 8)),
    ("sub_pel_filters_8lp", "vp9_filter.c", "int16_t", (16, 8)),
    ("sub_pel_filters_8s", "vp9_filter.c", "int16_t", (16, 8)),
    ("bilinear_filters", "vp9_filter.c", "int16_t", (16, 8)),
    ("mode_lf_lut", "vp9_loopfilter.c", "int32_t", (14,)),
    ("mv_ref_blocks", "vp9_mvref_common.c", "int32_t", (13, 8, 2)),
    ("counter_to_context", "vp9_mvref_common.c", "int32_t", (19,)),
    ("mode_2_counter", "vp9_mvref_common.c", "int32_t", (14,)),
    ("inv_map_table.0", None, "uint8_t", (255,)),
    ("vp9_pt_energy_class", None, "uint8_t", (12,)),
    ("vp9_coef_con_tree", None, "int8_t", (22,)),
    ("partition_context_lookup", None, "uint8_t", (13, 2)),
    ("subsize_lookup", None, "uint8_t", (4, 13)),
    ("ss_size_lookup", None, "uint8_t", (13, 2, 2)),
    ("uv_txsize_lookup", None, "uint8_t", (13, 4, 2, 2)),
    ("max_txsize_lookup", None, "uint8_t", (13,)),
    ("size_group_lookup", None, "uint8_t", (13,)),
    ("num_8x8_blocks_wide_lookup", None, "uint8_t", (13,)),
    ("num_8x8_blocks_high_lookup", None, "uint8_t", (13,)),
    ("b_width_log2_lookup", None, "uint8_t", (13,)),
    ("tx_mode_to_biggest_tx_size", None, "uint8_t", (5,)),
    ("intra_mode_to_tx_type_lookup", None, "int32_t", (10,)),
    ("vp9_intra_mode_tree", None, "int8_t", (18,)),
    ("vp9_inter_mode_tree", None, "int8_t", (6,)),
    ("vp9_partition_tree", None, "int8_t", (6,)),
    ("vp9_switchable_interp_tree", None, "int8_t", (4,)),
    ("vp9_segment_tree", None, "int8_t", (14,)),
    ("vp9_mv_joint_tree", None, "int8_t", (6,)),
    ("vp9_mv_class_tree", None, "int8_t", (20,)),
    ("vp9_mv_class0_tree", None, "int8_t", (2,)),
    ("vp9_mv_fp_tree", None, "int8_t", (6,)),
]
_FMT = {"uint8_t": "B", "int8_t": "b", "int16_t": "h", "int32_t": "i"}

NOTICE = """\
// Copyright (c) 2010 The WebM project authors. All Rights Reserved.
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions are
// met:
//   * Redistributions of source code must retain the above copyright
//     notice, this list of conditions and the following disclaimer.
//   * Redistributions in binary form must reproduce the above copyright
//     notice, this list of conditions and the following disclaimer in the
//     documentation and/or other materials provided with the distribution.
//   * Neither the name of Google, nor the WebM Project, nor the names of
//     its contributors may be used to endorse or promote products derived
//     from this software without specific prior written permission.
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
// IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO,
// THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR
// PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT HOLDER OR
// CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
// EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
// PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
// PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
// LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
// NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
// SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""


def default_library() -> str:
    """The libvpx shared object beside OpenCV's wheel (found without
    importing cv2)."""
    for base in sys.path:
        hits = glob.glob(os.path.join(base, "opencv_python.libs",
                                      "libvpx-*.so*"))
        if hits:
            return hits[0]
    raise FileNotFoundError("no opencv_python.libs/libvpx-*.so on sys.path")


def symbols(path: str) -> dict:
    """{(file, name): bytes} and {(None, name): bytes} of every OBJECT
    symbol in the ELF64 ``.symtab`` of ``path``; ``file`` is the STT_FILE
    symbol that precedes a local one."""
    data = open(path, "rb").read()
    if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
        raise ValueError(f"{path}: not a little-endian ELF64 file")
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize)
                for i in range(shnum)]
    symtab = next((s for s in sections if s[1] == 2), None)   # SHT_SYMTAB
    if symtab is None:
        raise ValueError(f"{path}: no .symtab")
    strtab = sections[symtab[6]]
    out, unit = {}, None
    for k in range(symtab[5] // symtab[9]):
        name_off, info, _, shndx, value, size = struct.unpack_from(
            "<IBBHQQ", data, symtab[4] + k * symtab[9])
        end = data.index(b"\0", strtab[4] + name_off)
        name = data[strtab[4] + name_off:end].decode()
        kind = info & 0xF
        if kind == 4:                                           # STT_FILE
            unit = name
        elif kind == 1 and 0 < shndx < shnum and size:          # OBJECT
            sec = sections[shndx]
            if sec[1] == 8:                                     # NOBITS
                continue
            off = sec[4] + value - sec[3]
            blob = data[off:off + size]
            out[(unit if info >> 4 == 0 else None, name)] = blob
            out.setdefault((None, name), blob)
    return out


def values(syms: dict, name: str, unit, ctype: str, dims) -> list:
    blob = syms.get((unit, name)) if unit else syms.get((None, name))
    if blob is None:
        raise KeyError(f"{name} ({unit or 'any unit'}) not in the library")
    n = 1
    for d in dims:
        n *= d
    if struct.calcsize("<" + _FMT[ctype]) * n != len(blob):
        raise ValueError(f"{name}: {len(blob)} bytes, expected {dims} "
                         f"{ctype}")
    return list(struct.unpack("<%d%s" % (n, _FMT[ctype]), blob))


def _c_array(vals: list, dims) -> str:
    if len(dims) == 1:
        body, line = [], ""
        for v in vals:
            item = f"{v}, "
            if len(line) + len(item) > 76:
                body.append(line.rstrip())
                line = ""
            line += item
        body.append(line.rstrip().rstrip(","))
        return "{" + "\n ".join(body) + "}"
    step = len(vals) // dims[0]
    return "{" + ",\n ".join(_c_array(vals[i:i + step], dims[1:])
                             for i in range(0, len(vals), step)) + "}"


def render(lib: str) -> str:
    syms = symbols(lib)
    parts = [
        "// vp9_tables.h — the VP9 decoder's constant tables "
        "(native/vp9.cpp),\n// written by scripts/vp9_tables.py from "
        "the symbols of libvpx, whose\n// notice follows.  Do not edit; "
        "rewrite with the script.\n//\n" + NOTICE,
        "#ifndef SLAM_NATIVE_VP9_TABLES_H_\n#define SLAM_NATIVE_VP9_TABLES_H_"
        "\n\n#include <cstdint>\n\nnamespace vp9_tables {\n"]
    for name, unit, ctype, dims in TABLES:
        vals = values(syms, name, unit, ctype, dims)
        dim = "".join(f"[{d}]" for d in dims)
        # a function's static table is named "<name>.<n>" in the symtab
        parts.append(f"\nconst {ctype} {name.split('.')[0]}{dim} =\n"
                     + _c_array(vals, dims) + ";\n")
    names = " \\\n".join(f"  X({n.split('.')[0]})" for n, *_ in TABLES)
    parts.append("\n// every table above, for a lookup by name\n"
                 f"#define VP9_TABLES(X) \\\n{names}\n")
    parts.append("\n}  // namespace vp9_tables\n\n"
                 "#endif  // SLAM_NATIVE_VP9_TABLES_H_\n")
    return "".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    text = render(args.lib or default_library())
    if args.check:
        same = open(HEADER).read() == text
        print("vp9_tables.h", "matches" if same else "differs")
        return 0 if same else 1
    with open(HEADER, "w") as fh:
        fh.write(text)
    print(f"wrote {HEADER} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
