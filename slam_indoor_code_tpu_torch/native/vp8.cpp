// vp8 — a VP8 video decoder (RFC 6386: what browsers' MediaRecorder and
// OpenCV's `VP80` writer record in WebM/Matroska) with no library but the
// C++ standard library.
//
// It gives the pixels FFmpeg's (and libvpx's) decoder gives, bit for bit:
//   - the boolean decoder, read as FFmpeg's range coder reads it (two bytes
//     at a time; a token partition that ends more than ten macroblocks
//     early stops the frame there);
//   - the frame header: key-frame start code and size, colour space and
//     clamping, segmentation with its map and quantiser/filter-level values
//     (absolute or delta), simple or normal loop filter with level and
//     sharpness, the mode/reference filter-level deltas, 1/2/4/8 token
//     partitions, the quantiser index and its five deltas, golden/altref
//     refresh with the copy flags and sign bias, refresh_entropy_probs (the
//     probabilities saved and restored), refresh_last, the coefficient,
//     mode and motion-vector probability updates, mb_no_coeff_skip;
//   - intra modes (key-frame B_PRED contexts, the inter-frame trees and
//     probabilities, chroma modes) with 127 above and 129 left of the
//     frame; inter modes through find_near_mvs (sign-bias inversion, the
//     mode contexts, near/nearest/best clamped to the frame plus 16 pixels)
//     with NEW/ZERO/NEAREST/NEAR/SPLITMV in 16x8, 8x16, 8x8 and 4x4;
//   - tokens with bands, above/left contexts, Y2 or not, no EOB after a
//     zero, DCT_CAT1-6; dequantisation (Y2 DC x2, AC x155/100 at least 8,
//     UV DC at most 132); the inverse WHT and the 20091/35468 IDCT;
//   - prediction: the 6-tap filter in version 0, bilinear in versions 1-3,
//     full-pixel chroma in version 3, references replicated beyond the
//     macroblock-aligned frame; B_PRED's above-right from the macroblock
//     row above; intra prediction reads the unfiltered reconstruction;
//   - the loop filter (the header's filter_type picks simple or normal),
//     macroblock by macroblock in raster order: left edge, inner vertical
//     edges, top edge, inner horizontal edges, the key/inter HEV
//     thresholds, the interior limit from sharpness, inner edges skipped
//     in macroblocks with no coefficient that are not B_PRED or SPLITMV;
//   - the crop to the frame's size and YUV 4:2:0 -> RGB as swscale does it
//     for OpenCV (swscale_rgb.h), or, for a lossy WebP photo's key frame,
//     as libwebp does it (webp_rgb below: its fancy upsampler).
// A frame with show_frame 0 updates the references and gives no frame.  A
// token partition that ends early stops the frame where FFmpeg stops it:
// the frame is given (and kept as a reference) with its rows from there
// on taken from the last frame.  A corrupt or truncated frame header, and
// an inter frame before the first key frame, give no frame and leave the
// references as they were.  A key frame
// that changes the size, and the full-range flag (clamping_type 1, which
// FFmpeg reads as full-range colour), raise with the feature named.
// A lossy WebP photo (`webp`, vp8dec_set_webp) is read with libwebp's
// refusals in place of that leniency (vp8_dec.c): the partition table
// (a size past the data is the rest of it; the last partition must hold
// a byte), clamping_type ignored, and no frame where the header, partition
// 0 after a row's modes, or a macroblock's tokens need a byte past their
// partition (the bit reader's libwebp_eof).
//
// The probability tables are RFC 6386's (and libvpx's):
//
//   Copyright (c) 2010, 2011, Google Inc. All rights reserved.
//
//   Redistribution and use in source and binary forms, with or without
//   modification, are permitted provided that the following conditions are
//   met:
//     * Redistributions of source code must retain the above copyright
//       notice, this list of conditions and the following disclaimer.
//     * Redistributions in binary form must reproduce the above copyright
//       notice, this list of conditions and the following disclaimer in the
//       documentation and/or other materials provided with the distribution.
//     * Neither the name of Google, nor the WebM Project, nor the names of
//       its contributors may be used to endorse or promote products derived
//       from this software without specific prior written permission.
//   THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
//   IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO,
//   THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR
//   PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT HOLDER OR
//   CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
//   EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
//   PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
//   PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
//   LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
//   NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
//   SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
//
// C ABI; Python binds it through ctypes (io/vp8.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libvp8dec.so vp8.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <type_traits>
#include <vector>

#include "swscale_rgb.h"
#include "vpx_rac.h"

namespace {

using swscale_rgb::clip8;

enum Status { kFrame = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3,
              kSmall = 4 };

struct Error {
  Status status;
  std::string msg;
};

[[noreturn]] void unsupported(const std::string& what) {
  throw Error{kUnsupported, "VP8 " + what + " is not decoded"};
}

[[noreturn]] void corrupt(const std::string& what) {
  throw Error{kCorrupt, "corrupt VP8 frame: " + what};
}

// ---------------------------------------------------------------- tables

const uint8_t kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157};

const uint16_t kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kCoefDefault[4][8][3][11] = {
 {
  {
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  {
   {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
   {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
   {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
  {
   {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
   {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
   {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
  {
   {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
   {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
   {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
  {
   {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
   {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
   {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
  {
   {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
   {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
   {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
  {
   {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
   {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
   {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
  {
   {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {
  {
   {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
   {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
   {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
  {
   {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
   {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
   {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
  {
   {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
   {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
   {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
  {
   {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
   {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
   {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
  {
   {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
   {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
   {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
  {
   {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
   {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
   {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
  {
   {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
   {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
   {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
  {
   {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
   {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {
  {
   {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
   {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
   {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
  {
   {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
   {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
   {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
  {
   {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
   {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
   {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
  {
   {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
   {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
   {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
  {
   {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
   {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {
   {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {
   {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
   {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
   {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {
  {
   {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
   {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
   {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
  {
   {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
   {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
   {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
  {
   {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
   {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
   {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
  {
   {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
   {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
   {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
  {
   {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
   {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
   {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
  {
   {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
   {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
   {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
  {
   {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
   {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
   {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
  {
   {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

const uint8_t kCoefUpdate[4][8][3][11] = {
 {
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
   {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {
   {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
   {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
  {
   {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {
   {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
   {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
  {
   {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {
   {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
  {
   {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

const uint8_t kKfBmodeProb[10][10][9] = {
 {
  {231, 120, 48, 89, 115, 113, 120, 152, 112},
  {152, 179, 64, 126, 170, 118, 46, 70, 95},
  {175, 69, 143, 80, 85, 82, 72, 155, 103},
  {56, 58, 10, 171, 218, 189, 17, 13, 152},
  {144, 71, 10, 38, 171, 213, 144, 34, 26},
  {114, 26, 17, 163, 44, 195, 21, 10, 173},
  {121, 24, 80, 195, 26, 62, 44, 64, 85},
  {170, 46, 55, 19, 136, 160, 33, 206, 71},
  {63, 20, 8, 114, 114, 208, 12, 9, 226},
  {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {
  {134, 183, 89, 137, 98, 101, 106, 165, 148},
  {72, 187, 100, 130, 157, 111, 32, 75, 80},
  {66, 102, 167, 99, 74, 62, 40, 234, 128},
  {41, 53, 9, 178, 241, 141, 26, 8, 107},
  {104, 79, 12, 27, 217, 255, 87, 17, 7},
  {74, 43, 26, 146, 73, 166, 49, 23, 157},
  {65, 38, 105, 160, 51, 52, 31, 115, 128},
  {87, 68, 71, 44, 114, 51, 15, 186, 23},
  {47, 41, 14, 110, 182, 183, 21, 17, 194},
  {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {
  {88, 88, 147, 150, 42, 46, 45, 196, 205},
  {43, 97, 183, 117, 85, 38, 35, 179, 61},
  {39, 53, 200, 87, 26, 21, 43, 232, 171},
  {56, 34, 51, 104, 114, 102, 29, 93, 77},
  {107, 54, 32, 26, 51, 1, 81, 43, 31},
  {39, 28, 85, 171, 58, 165, 90, 98, 64},
  {34, 22, 116, 206, 23, 34, 43, 166, 73},
  {68, 25, 106, 22, 64, 171, 36, 225, 114},
  {34, 19, 21, 102, 132, 188, 16, 76, 124},
  {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {
  {193, 101, 35, 159, 215, 111, 89, 46, 111},
  {60, 148, 31, 172, 219, 228, 21, 18, 111},
  {112, 113, 77, 85, 179, 255, 38, 120, 114},
  {40, 42, 1, 196, 245, 209, 10, 25, 109},
  {100, 80, 8, 43, 154, 1, 51, 26, 71},
  {88, 43, 29, 140, 166, 213, 37, 43, 154},
  {61, 63, 30, 155, 67, 45, 68, 1, 209},
  {142, 78, 78, 16, 255, 128, 34, 197, 171},
  {41, 40, 5, 102, 211, 183, 4, 1, 221},
  {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {
  {125, 98, 42, 88, 104, 85, 117, 175, 82},
  {95, 84, 53, 89, 128, 100, 113, 101, 45},
  {75, 79, 123, 47, 51, 128, 81, 171, 1},
  {57, 17, 5, 71, 102, 57, 53, 41, 49},
  {115, 21, 2, 10, 102, 255, 166, 23, 6},
  {38, 33, 13, 121, 57, 73, 26, 1, 85},
  {41, 10, 67, 138, 77, 110, 90, 47, 114},
  {101, 29, 16, 10, 85, 128, 101, 196, 26},
  {57, 18, 10, 102, 102, 213, 34, 20, 43},
  {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {
  {138, 31, 36, 171, 27, 166, 38, 44, 229},
  {67, 87, 58, 169, 82, 115, 26, 59, 179},
  {63, 59, 90, 180, 59, 166, 93, 73, 154},
  {40, 40, 21, 116, 143, 209, 34, 39, 175},
  {57, 46, 22, 24, 128, 1, 54, 17, 37},
  {47, 15, 16, 183, 34, 223, 49, 45, 183},
  {46, 17, 33, 183, 6, 98, 15, 32, 183},
  {65, 32, 73, 115, 28, 128, 23, 128, 205},
  {40, 3, 9, 115, 51, 192, 18, 6, 223},
  {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {
  {104, 55, 44, 218, 9, 54, 53, 130, 226},
  {64, 90, 70, 205, 40, 41, 23, 26, 57},
  {54, 57, 112, 184, 5, 41, 38, 166, 213},
  {30, 34, 26, 133, 152, 116, 10, 32, 134},
  {75, 32, 12, 51, 192, 255, 160, 43, 51},
  {39, 19, 53, 221, 26, 114, 32, 73, 255},
  {31, 9, 65, 234, 2, 15, 1, 118, 73},
  {88, 31, 35, 67, 102, 85, 55, 186, 85},
  {56, 21, 23, 111, 59, 205, 45, 37, 192},
  {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {
  {102, 61, 71, 37, 34, 53, 31, 243, 192},
  {69, 60, 71, 38, 73, 119, 28, 222, 37},
  {68, 45, 128, 34, 1, 47, 11, 245, 171},
  {62, 17, 19, 70, 146, 85, 55, 62, 70},
  {75, 15, 9, 9, 64, 255, 184, 119, 16},
  {37, 43, 37, 154, 100, 163, 85, 160, 1},
  {63, 9, 92, 136, 28, 64, 32, 201, 85},
  {86, 6, 28, 5, 64, 255, 25, 248, 1},
  {56, 8, 17, 132, 137, 255, 55, 116, 128},
  {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {
  {164, 50, 31, 137, 154, 133, 25, 35, 218},
  {51, 103, 44, 131, 131, 123, 31, 6, 158},
  {86, 40, 64, 135, 148, 224, 45, 183, 128},
  {22, 26, 17, 131, 240, 154, 14, 1, 209},
  {83, 12, 13, 54, 192, 255, 68, 47, 28},
  {45, 16, 21, 91, 64, 222, 7, 1, 197},
  {56, 21, 39, 155, 60, 138, 23, 102, 213},
  {85, 26, 85, 85, 128, 128, 32, 146, 171},
  {18, 11, 7, 63, 144, 171, 4, 4, 246},
  {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {
  {190, 80, 35, 99, 180, 80, 126, 54, 45},
  {85, 126, 47, 87, 176, 51, 41, 20, 32},
  {101, 75, 128, 139, 118, 146, 116, 128, 85},
  {56, 41, 15, 176, 236, 85, 37, 9, 62},
  {146, 36, 19, 30, 171, 255, 97, 27, 20},
  {71, 30, 17, 119, 118, 255, 17, 18, 138},
  {101, 38, 60, 138, 55, 70, 43, 26, 142},
  {138, 45, 61, 62, 219, 1, 81, 188, 64},
  {32, 41, 20, 117, 151, 142, 20, 21, 163},
  {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

const uint8_t kMvDefault[2][19] = {
 {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
 {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};

const uint8_t kMvUpdate[2][19] = {
 {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
 {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};

const uint8_t kModeContexts[6][4] = {
 {7, 1, 1, 143},
 {14, 18, 14, 107},
 {135, 64, 57, 68},
 {60, 56, 128, 65},
 {159, 134, 128, 34},
 {234, 188, 128, 28}};

const uint8_t kSubMvRefProb[5][3] = {
 {147, 136, 18},
 {106, 145, 1},
 {179, 121, 1},
 {223, 1, 34},
 {208, 1, 1}};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
// The band of each coefficient position (a 17th entry for the position
// after the last, whose probabilities are never read).
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kCat1[] = {159, 0};
const uint8_t kCat2[] = {165, 145, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCatProbs[4] = {kCat3, kCat4, kCat5, kCat6};

const uint8_t kKfYmodeProb[4] = {145, 156, 163, 128};
const uint8_t kKfUvModeProb[3] = {142, 114, 183};
const uint8_t kYmodeProbDefault[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbDefault[3] = {162, 101, 204};
const uint8_t kBmodeProb[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kMbSplitProb[3] = {110, 111, 150};

// The six taps of each eighth-pixel position 1..7 (taps 1 and 4 negative).
const uint8_t kSubpel[7][6] = {
    {0, 6, 123, 12, 1, 0}, {2, 11, 108, 36, 8, 1}, {0, 9, 93, 50, 6, 0},
    {3, 16, 77, 77, 16, 3}, {0, 6, 50, 93, 9, 0}, {1, 8, 36, 108, 11, 2},
    {0, 1, 12, 123, 6, 0}};

// Macroblock luma modes, then the inter modes.
enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED, ZEROMV, NEARESTMV, NEARMV,
       NEWMV, SPLITMV };
// Subblock modes in RFC 6386's order (the index of kKfBmodeProb).
enum { B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED, B_RD_PRED,
       B_VR_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
// Split partitionings: 16x8 (top/bottom), 8x16 (left/right), 8x8, 4x4.
const uint8_t kMbSplits[4][16] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const uint8_t kMbSplitCount[4] = {2, 2, 4, 16};

// Trees as libvpx writes them: a positive entry is the index of the next
// node pair, a non-positive one minus a leaf.
const int8_t kKfYmodeTree[8] = {-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED,
                                -H_PRED, -TM_PRED};
const int8_t kYmodeTree[8] = {-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED,
                              -TM_PRED, -B_PRED};
const int8_t kUvModeTree[6] = {-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED};
const int8_t kBmodeTree[18] = {-B_DC_PRED, 2, -B_TM_PRED, 4, -B_VE_PRED, 6,
                               8, 12, -B_HE_PRED, 10, -B_RD_PRED, -B_VR_PRED,
                               -B_LD_PRED, 14, -B_VL_PRED, 16, -B_HD_PRED,
                               -B_HU_PRED};
// The subblock mode a whole-macroblock mode implies for the key-frame
// B_PRED contexts.
const uint8_t kImpliedBmode[4] = {B_DC_PRED, B_VE_PRED, B_HE_PRED,
                                  B_TM_PRED};

// RFC 6386's boolean decoder, as FFmpeg reads it (vpx_rac.h).
using vpx_rac::Bool;

// ---------------------------------------------------------------- frames

struct Frame {
  int w = 0, h = 0;  // the macroblock-aligned size; chroma is half
  std::vector<uint8_t> y, u, v;
  Frame(int width, int height)
      : w(width), h(height), y(size_t(w) * h),
        u(size_t(w / 2) * (h / 2)), v(size_t(w / 2) * (h / 2)) {}
};
using FramePtr = std::shared_ptr<Frame>;

struct Mv {
  int16_t y = 0, x = 0;
  bool operator==(const Mv& o) const { return y == o.y && x == o.x; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
  bool zero() const { return y == 0 && x == 0; }
};

struct MbInfo {
  uint8_t ymode = DC_PRED, uvmode = DC_PRED, ref = 0, segment = 0;
  uint8_t skip = 0;
  Mv mv;
  Mv bmv[16];
  uint8_t bmode[16] = {};  // B_DC_PRED: what lies outside the frame
};

struct Probs {
  uint8_t coef[4][8][3][11];
  uint8_t ymode[4], uvmode[3];
  uint8_t mv[2][19];
};

struct Quant {
  int y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac;
};

// ---------------------------------------------------------------- DSP

// The inverse WHT of the Y2 block into the DC of the 16 luma blocks.
void inverse_wht(const int16_t* in, int16_t (*out)[16]) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    int a = in[i] + in[12 + i], b = in[4 + i] + in[8 + i];
    int c = in[4 + i] - in[8 + i], d = in[i] - in[12 + i];
    t[i] = static_cast<int16_t>(a + b);
    t[4 + i] = static_cast<int16_t>(d + c);
    t[8 + i] = static_cast<int16_t>(a - b);
    t[12 + i] = static_cast<int16_t>(d - c);
  }
  for (int i = 0; i < 4; ++i) {
    int a = t[4 * i] + t[4 * i + 3] + 3, b = t[4 * i + 1] + t[4 * i + 2];
    int c = t[4 * i + 1] - t[4 * i + 2], d = t[4 * i] - t[4 * i + 3] + 3;
    out[4 * i][0] = static_cast<int16_t>((a + b) >> 3);
    out[4 * i + 1][0] = static_cast<int16_t>((d + c) >> 3);
    out[4 * i + 2][0] = static_cast<int16_t>((a - b) >> 3);
    out[4 * i + 3][0] = static_cast<int16_t>((d - c) >> 3);
  }
}

inline int mul20091(int a) { return ((a * 20091) >> 16) + a; }
inline int mul35468(int a) { return (a * 35468) >> 16; }

// VP8's inverse DCT of a 4x4 block added to dst: columns, then rows.
void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    int c = mul35468(in[4 + i]) - mul20091(in[12 + i]);
    int d = mul20091(in[4 + i]) + mul35468(in[12 + i]);
    t[4 * i] = static_cast<int16_t>(a + d);
    t[4 * i + 1] = static_cast<int16_t>(b + c);
    t[4 * i + 2] = static_cast<int16_t>(b - c);
    t[4 * i + 3] = static_cast<int16_t>(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    int a = t[i] + t[8 + i], b = t[i] - t[8 + i];
    int c = mul35468(t[4 + i]) - mul20091(t[12 + i]);
    int d = mul20091(t[4 + i]) + mul35468(t[12 + i]);
    uint8_t* o = dst + i * stride;
    o[0] = clip8(o[0] + ((a + d + 4) >> 3));
    o[1] = clip8(o[1] + ((b + c + 4) >> 3));
    o[2] = clip8(o[2] + ((b - c + 4) >> 3));
    o[3] = clip8(o[3] + ((a - d + 4) >> 3));
  }
}

inline bool any(const int16_t* b) {
  for (int i = 0; i < 16; ++i)
    if (b[i]) return true;
  return false;
}

inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}

// A 4x4 subblock predicted from its edge: A[-1] the corner, A[0..3] above,
// A[4..7] above-right, L[0..3] left.  B[r][c] as RFC 6386 section 12.3.
void predict4(int mode, const uint8_t* A, const uint8_t* L, uint8_t* dst,
              int stride) {
  uint8_t B[4][4];
  const int P = A[-1];
  // E: left from the bottom up, the corner, above.
  const int E[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
  switch (mode) {
    case B_DC_PRED: {
      int v = 4;
      for (int i = 0; i < 4; ++i) v += A[i] + L[i];
      for (auto& r : B) std::memset(r, v >> 3, 4);
      break;
    }
    case B_TM_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) B[r][c] = clip8(L[r] + A[c] - P);
      break;
    case B_VE_PRED:
      for (int c = 0; c < 4; ++c) {
        uint8_t v = avg3(A[c - 1], A[c], A[c + 1]);
        for (int r = 0; r < 4; ++r) B[r][c] = v;
      }
      break;
    case B_HE_PRED: {
      const uint8_t rows[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                               avg3(L[1], L[2], L[3]),
                               avg3(L[2], L[3], L[3])};
      for (int r = 0; r < 4; ++r) std::memset(B[r], rows[r], 4);
      break;
    }
    case B_LD_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          int k = r + c;
          B[r][c] = k < 6 ? avg3(A[k], A[k + 1], A[k + 2])
                          : avg3(A[6], A[7], A[7]);
        }
      break;
    case B_RD_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          int k = 4 - r + c;
          B[r][c] = avg3(E[k - 1], E[k], E[k + 1]);
        }
      break;
    case B_VR_PRED:
      B[3][0] = avg3(E[1], E[2], E[3]);
      B[2][0] = avg3(E[2], E[3], E[4]);
      B[3][1] = B[1][0] = avg3(E[3], E[4], E[5]);
      B[2][1] = B[0][0] = avg2(E[4], E[5]);
      B[3][2] = B[1][1] = avg3(E[4], E[5], E[6]);
      B[2][2] = B[0][1] = avg2(E[5], E[6]);
      B[3][3] = B[1][2] = avg3(E[5], E[6], E[7]);
      B[2][3] = B[0][2] = avg2(E[6], E[7]);
      B[1][3] = avg3(E[6], E[7], E[8]);
      B[0][3] = avg2(E[7], E[8]);
      break;
    case B_VL_PRED:
      B[0][0] = avg2(A[0], A[1]);
      B[1][0] = avg3(A[0], A[1], A[2]);
      B[2][0] = B[0][1] = avg2(A[1], A[2]);
      B[1][1] = B[3][0] = avg3(A[1], A[2], A[3]);
      B[2][1] = B[0][2] = avg2(A[2], A[3]);
      B[3][1] = B[1][2] = avg3(A[2], A[3], A[4]);
      B[2][2] = B[0][3] = avg2(A[3], A[4]);
      B[3][2] = B[1][3] = avg3(A[3], A[4], A[5]);
      B[2][3] = avg3(A[4], A[5], A[6]);
      B[3][3] = avg3(A[5], A[6], A[7]);
      break;
    case B_HD_PRED:
      B[3][0] = avg2(E[0], E[1]);
      B[3][1] = avg3(E[0], E[1], E[2]);
      B[2][0] = B[3][2] = avg2(E[1], E[2]);
      B[2][1] = B[3][3] = avg3(E[1], E[2], E[3]);
      B[2][2] = B[1][0] = avg2(E[2], E[3]);
      B[2][3] = B[1][1] = avg3(E[2], E[3], E[4]);
      B[1][2] = B[0][0] = avg2(E[3], E[4]);
      B[1][3] = B[0][1] = avg3(E[3], E[4], E[5]);
      B[0][2] = avg3(E[4], E[5], E[6]);
      B[0][3] = avg3(E[5], E[6], E[7]);
      break;
    default:  // B_HU_PRED
      B[0][0] = avg2(L[0], L[1]);
      B[0][1] = avg3(L[0], L[1], L[2]);
      B[0][2] = B[1][0] = avg2(L[1], L[2]);
      B[0][3] = B[1][1] = avg3(L[1], L[2], L[3]);
      B[1][2] = B[2][0] = avg2(L[2], L[3]);
      B[1][3] = B[2][1] = avg3(L[2], L[3], L[3]);
      B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] =
          static_cast<uint8_t>(L[3]);
      break;
  }
  for (int r = 0; r < 4; ++r) std::memcpy(dst + r * stride, B[r], 4);
}

// An n x n block (16 luma, 8 chroma) predicted by a whole-macroblock mode;
// `up`/`left` say whether the macroblock has a neighbour there (DC_PRED
// averages only those), A and L hold 127/129 where it does not.
void predict_mb(int mode, int n, const uint8_t* A, const uint8_t* L, int P,
                bool up, bool left, uint8_t* dst, int stride) {
  for (int r = 0; r < n; ++r) {
    uint8_t* o = dst + r * stride;
    switch (mode) {
      case DC_PRED: {
        int v = 128;
        if (up || left) {
          int sum = 0, shift = (n == 16 ? 3 : 2) + up + left;
          for (int i = 0; i < n; ++i) sum += (up ? A[i] : 0) + (left ? L[i] : 0);
          v = (sum + (1 << (shift - 1))) >> shift;
        }
        std::memset(o, v, n);
        break;
      }
      case V_PRED:
        std::memcpy(o, A, n);
        break;
      case H_PRED:
        std::memset(o, L[r], n);
        break;
      default:  // TM_PRED
        for (int c = 0; c < n; ++c) o[c] = clip8(L[r] + A[c] - P);
        break;
    }
  }
}

// Motion-compensated prediction of a bw x bh block whose top-left lies at
// (x, y) of a reference plane of size pw x ph (macroblock-aligned; beyond
// it the edge is replicated), fx/fy in eighths of a pixel: the 6-tap
// filter (horizontal pass first, clipped) or, for versions 1-3, bilinear.
void predict_inter(const uint8_t* ref, int pw, int ph, int x, int y, int bw,
                   int bh, int fx, int fy, bool sixtap, uint8_t* dst,
                   int dstride) {
  // The source window: two columns/rows before the block, three after.
  const int ws = bw + 5, wh = bh + 5;
  uint8_t win[21 * 21];
  const uint8_t* src;
  int ss;
  if (x - 2 >= 0 && y - 2 >= 0 && x + bw + 3 <= pw && y + bh + 3 <= ph) {
    src = ref + int64_t(y - 2) * pw + (x - 2);
    ss = pw;
  } else {
    for (int r = 0; r < wh; ++r) {
      const uint8_t* row =
          ref + int64_t(std::clamp(y - 2 + r, 0, ph - 1)) * pw;
      for (int c = 0; c < ws; ++c)
        win[r * ws + c] = row[std::clamp(x - 2 + c, 0, pw - 1)];
    }
    src = win;
    ss = ws;
  }
  src += 2 * ss + 2;  // the block's top-left
  if (!fx && !fy) {
    for (int r = 0; r < bh; ++r)
      std::memcpy(dst + r * dstride, src + r * ss, bw);
    return;
  }
  if (sixtap) {
    auto tap = [](const uint8_t* p, int s, const uint8_t* F) {
      return clip8((F[2] * p[0] - F[1] * p[-s] + F[0] * p[-2 * s] +
                    F[3] * p[s] - F[4] * p[2 * s] + F[5] * p[3 * s] + 64) >>
                   7);
    };
    if (fx && fy) {
      uint8_t tmp[21 * 16];
      const uint8_t* F = kSubpel[fx - 1];
      for (int r = -2; r < bh + 3; ++r)
        for (int c = 0; c < bw; ++c)
          tmp[(r + 2) * bw + c] = tap(src + r * ss + c, 1, F);
      F = kSubpel[fy - 1];
      for (int r = 0; r < bh; ++r)
        for (int c = 0; c < bw; ++c)
          dst[r * dstride + c] = tap(tmp + (r + 2) * bw + c, bw, F);
    } else if (fx) {
      const uint8_t* F = kSubpel[fx - 1];
      for (int r = 0; r < bh; ++r)
        for (int c = 0; c < bw; ++c)
          dst[r * dstride + c] = tap(src + r * ss + c, 1, F);
    } else {
      const uint8_t* F = kSubpel[fy - 1];
      for (int r = 0; r < bh; ++r)
        for (int c = 0; c < bw; ++c)
          dst[r * dstride + c] = tap(src + r * ss + c, ss, F);
    }
    return;
  }
  const int a = 8 - fx, b = fx, c = 8 - fy, d = fy;
  uint8_t tmp[17 * 16];
  for (int r = 0; r < bh + 1; ++r)
    for (int k = 0; k < bw; ++k) {
      const uint8_t* p = src + r * ss + k;
      tmp[r * bw + k] = static_cast<uint8_t>(
          fx ? (a * p[0] + b * p[1] + 4) >> 3 : p[0]);
    }
  for (int r = 0; r < bh; ++r)
    for (int k = 0; k < bw; ++k) {
      const uint8_t* p = tmp + r * bw + k;
      dst[r * dstride + k] = static_cast<uint8_t>(
          fy ? (c * p[0] + d * p[bw] + 4) >> 3 : p[0]);
    }
}

// ---------------------------------------------------------------- filter
// p points at q0; s steps across the edge.

inline int clamp_s8(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }

inline bool simple_limit(const uint8_t* p, int s, int E) {
  return 2 * std::abs(p[-s] - p[0]) + (std::abs(p[-2 * s] - p[s]) >> 1) <=
         E;
}

inline bool normal_limit(const uint8_t* p, int s, int E, int I) {
  return simple_limit(p, s, E) && std::abs(p[-4 * s] - p[-3 * s]) <= I &&
         std::abs(p[-3 * s] - p[-2 * s]) <= I &&
         std::abs(p[-2 * s] - p[-s]) <= I &&
         std::abs(p[3 * s] - p[2 * s]) <= I &&
         std::abs(p[2 * s] - p[s]) <= I && std::abs(p[s] - p[0]) <= I;
}

inline bool hev(const uint8_t* p, int s, int t) {
  return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
}

inline void filter_common(uint8_t* p, int s, bool four_tap) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  int a = 3 * (q0 - p0);
  if (four_tap) a += clamp_s8(p1 - q1);
  a = clamp_s8(a);
  int f1 = std::min(a + 4, 127) >> 3, f2 = std::min(a + 3, 127) >> 3;
  p[-s] = clip8(p0 + f2);
  p[0] = clip8(q0 - f1);
  if (!four_tap) {
    a = (f1 + 1) >> 1;
    p[-2 * s] = clip8(p1 + a);
    p[s] = clip8(q1 - a);
  }
}

inline void filter_mbedge(uint8_t* p, int s) {
  int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  int q0 = p[0], q1 = p[s], q2 = p[2 * s];
  int w = clamp_s8(clamp_s8(p1 - q1) + 3 * (q0 - p0));
  int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
  p[-3 * s] = clip8(p2 + a2);
  p[-2 * s] = clip8(p1 + a1);
  p[-s] = clip8(p0 + a0);
  p[0] = clip8(q0 - a0);
  p[s] = clip8(q1 - a1);
  p[2 * s] = clip8(q2 - a2);
}

// n pixels along an edge: `along` steps along it, `across` over it.
void edge_normal(uint8_t* p, int along, int across, int n, int E, int I,
                 int t, bool mb_edge) {
  for (int i = 0; i < n; ++i, p += along) {
    if (!normal_limit(p, across, E, I)) continue;
    if (hev(p, across, t))
      filter_common(p, across, true);
    else if (mb_edge)
      filter_mbedge(p, across);
    else
      filter_common(p, across, false);
  }
}

void edge_simple(uint8_t* p, int along, int across, int n, int E) {
  for (int i = 0; i < n; ++i, p += along)
    if (simple_limit(p, across, E)) filter_common(p, across, true);
}

// ---------------------------------------------------------------- decoder

struct Segmentation {
  bool enabled = false, update_map = false, absolute = false;
  int quant[4] = {}, lf[4] = {};
  uint8_t tree[3] = {255, 255, 255};
};

struct LfDeltas {
  bool enabled = false;
  int ref[4] = {}, mode[4] = {};
};

class Decoder {
 public:
  int width = 0, height = 0;
  FramePtr shown;  // the last frame given
  // A lossy WebP photo: libwebp's refusals in place of FFmpeg's leniency.
  bool webp = false;

  Status decode(const uint8_t* data, int64_t n);

 private:
  void frame_header(Bool& b);
  void read_modes(Bool& b, MbInfo& m, int mx, int my, uint8_t* seg);
  void read_mvs(Bool& b, MbInfo& m, int mx, int my);
  Mv read_mv(Bool& b);
  void read_split(Bool& b, MbInfo& m, int mx, int my);
  bool read_tokens(Bool& b, MbInfo& m, uint8_t* top, uint8_t* left);
  int read_block(Bool& b, int type, int ctx, int first, int16_t* out,
                 int dc_q, int ac_q);
  void reconstruct(const MbInfo& m, int mx, int my);
  void intra_luma(const MbInfo& m, int mx, int my);
  void intra_chroma(const MbInfo& m, int mx, int my);
  void inter(const MbInfo& m, int mx, int my);
  void conceal(int mx, int my);
  void loop_filter(int rows);

  MbInfo& mb(int mx, int my) { return mbs_[(my + 1) * (mbw_ + 1) + mx + 1]; }

  // state carried from frame to frame
  Probs probs_{}, saved_{};
  Segmentation seg_;
  LfDeltas lf_;
  std::vector<uint8_t> segmap_;
  int sign_bias_[4] = {};
  FramePtr refs_[4];  // [1] last, [2] golden, [3] altref
  bool have_key_ = false;

  // this frame
  bool key_ = false, sixtap_ = true, fullpel_chroma_ = false;
  bool filter_simple_ = false, skip_enabled_ = false;
  int filter_level_ = 0, sharpness_ = 0, nparts_ = 1;
  int prob_skip_ = 0, prob_intra_ = 0, prob_last_ = 0, prob_gf_ = 0;
  Quant quant_[4]{};
  Bool parts_[8];
  int mbw_ = 0, mbh_ = 0;
  std::vector<MbInfo> mbs_;
  std::vector<uint8_t> lf_level_, lf_inner_;
  FramePtr cur_;
  int16_t coef_[25][16];
};

Status Decoder::decode(const uint8_t* data, int64_t n) {
  if (n < 3) corrupt("shorter than its frame tag");
  const uint8_t* const frame_end = data + n;
  const bool key = !(data[0] & 1);
  const int version = (data[0] >> 1) & 7;
  const bool show = data[0] & 0x10;
  const int64_t first_size = (data[0] | (data[1] << 8) | (data[2] << 16)) >> 5;
  const uint8_t* p = data + 3;
  int64_t left = n - 3;
  if (version > 3) unsupported("version " + std::to_string(version));
  if (first_size > left - 7 * key)
    corrupt("first partition larger than the frame");
  key_ = key;
  int new_w = 0, new_h = 0;
  sixtap_ = version == 0;
  fullpel_chroma_ = version == 3;
  if (key) {
    if (p[0] != 0x9d || p[1] != 0x01 || p[2] != 0x2a)
      corrupt("no key-frame start code");
    int w = (p[3] | (p[4] << 8)) & 0x3fff, h = (p[5] | (p[6] << 8)) & 0x3fff;
    p += 7;
    left -= 7;
    if (!w || !h) corrupt("a key frame of size zero");
    if (width && (w != width || h != height))
      unsupported("key frame that changes the frame size (" +
                  std::to_string(width) + "x" + std::to_string(height) +
                  " to " + std::to_string(w) + "x" + std::to_string(h) +
                  ")");
    new_w = w;
    new_h = h;
    std::memcpy(probs_.coef, kCoefDefault, sizeof(probs_.coef));
    std::memcpy(probs_.ymode, kYmodeProbDefault, 4);
    std::memcpy(probs_.uvmode, kUvModeProbDefault, 3);
    std::memcpy(probs_.mv, kMvDefault, sizeof(probs_.mv));
    seg_ = Segmentation();
    lf_ = LfDeltas();
    sign_bias_[2] = sign_bias_[3] = 0;
  }
  if (first_size < 1) corrupt("an empty first partition");
  Bool b;
  b.init(p, first_size, frame_end);
  p += first_size;
  left -= first_size;
  if (key) {
    b.get(128);  // colour space: FFmpeg reads and ignores it
    if (b.get(128) && !webp)  // libwebp ignores it too
      unsupported("full-range colour (clamping_type 1)");
  }
  frame_header(b);
  if (webp && b.libwebp_eof())
    corrupt("the segment or filter header past partition 0");
  // the token partitions
  const uint8_t* sizes = p;
  p += 3 * (nparts_ - 1);
  left -= 3 * (nparts_ - 1);
  if (left < 0) corrupt("partition sizes past the end of the frame");
  for (int i = 0; i < nparts_ - 1; ++i) {
    int64_t size = sizes[3 * i] | (sizes[3 * i + 1] << 8) |
                   (sizes[3 * i + 2] << 16);
    if (webp) {
      size = std::min(size, left);  // libwebp's ParsePartitions
    } else if (left - size < 0 || size < 1) {
      corrupt("a token partition past the end of the frame");
    }
    parts_[i].init(p, size, frame_end);
    p += size;
    left -= size;
  }
  if (webp && left < 1) corrupt("the last token partition is empty");
  parts_[nparts_ - 1].init(p, left, frame_end);
  if (new_w && !width) {
    width = new_w;
    height = new_h;
    mbw_ = (new_w + 15) >> 4;
    mbh_ = (new_h + 15) >> 4;
    segmap_.assign(size_t(mbw_) * mbh_, 0);
  }
  // what follows the partition sizes in the first partition
  const int yac = b.literal(7);
  const int ydc = b.signed_literal(4), y2dc = b.signed_literal(4),
            y2ac = b.signed_literal(4), uvdc = b.signed_literal(4),
            uvac = b.signed_literal(4);
  for (int i = 0; i < 4; ++i) {
    int q = yac;
    if (seg_.enabled) q = seg_.quant[i] + (seg_.absolute ? 0 : yac);
    auto at = [&](int delta) { return std::clamp(q + delta, 0, 127); };
    Quant& z = quant_[i];
    z.y_dc = kDcQ[at(ydc)];
    z.y_ac = kAcQ[at(0)];
    z.y2_dc = kDcQ[at(y2dc)] * 2;
    z.y2_ac = std::max(kAcQ[at(y2ac)] * 155 / 100, 8);
    z.uv_dc = std::min<int>(kDcQ[at(uvdc)], 132);
    z.uv_ac = kAcQ[at(uvac)];
  }
  // reference updates: the source of the new golden and altref frames
  int golden_src = 2, altref_src = 3;  // unchanged
  if (!key) {
    const int refresh_golden = b.get(128), refresh_altref = b.get(128);
    auto source = [&](int refresh, int self) {
      if (refresh) return 0;  // this frame
      switch (b.literal(2)) {
        case 1: return 1;
        case 2: return self == 2 ? 3 : 2;
      }
      return self;
    };
    golden_src = source(refresh_golden, 2);
    altref_src = source(refresh_altref, 3);
    sign_bias_[2] = b.get(128);
    sign_bias_[3] = b.get(128);
  } else {
    golden_src = altref_src = 0;
  }
  const bool refresh_probs = b.get(128);
  if (!refresh_probs) saved_ = probs_;
  const bool update_last = key || b.get(128);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 11; ++l)
          if (b.get(kCoefUpdate[i][j][k][l]))
            probs_.coef[i][j][k][l] = static_cast<uint8_t>(b.literal(8));
  skip_enabled_ = b.get(128);
  prob_skip_ = skip_enabled_ ? b.literal(8) : 0;
  if (!key) {
    prob_intra_ = b.literal(8);
    prob_last_ = b.literal(8);
    prob_gf_ = b.literal(8);
    if (b.get(128))
      for (auto& q : probs_.ymode) q = static_cast<uint8_t>(b.literal(8));
    if (b.get(128))
      for (auto& q : probs_.uvmode) q = static_cast<uint8_t>(b.literal(8));
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 19; ++j)
        if (b.get(kMvUpdate[i][j])) {
          int v = b.literal(7) << 1;
          probs_.mv[i][j] = static_cast<uint8_t>(v ? v : 1);
        }
  }
  if (!key && !have_key_) corrupt("an inter frame before the first key frame");

  // macroblocks
  cur_ = std::make_shared<Frame>(mbw_ * 16, mbh_ * 16);
  mbs_.assign(size_t(mbw_ + 1) * (mbh_ + 1), MbInfo());
  lf_level_.assign(size_t(mbw_) * mbh_, 0);
  lf_inner_.assign(size_t(mbw_) * mbh_, 0);
  std::vector<uint8_t> segmap = segmap_;
  std::vector<uint8_t> top_nnz(size_t(mbw_) * 9, 0);
  // FFmpeg tests the token partition at the start of each row and before
  // each macroblock's coefficients; where it fails, FFmpeg stops the frame
  // there (its rows above decoded and filtered, the rest undefined) and
  // still gives it and keeps it as a reference.  The rest is taken from
  // the last frame here.
  int stop_x = -1, stop_y = mbh_;
  for (int my = 0; my < mbh_ && stop_x < 0; ++my) {
    Bool& tb = parts_[my & (nparts_ - 1)];
    if (!webp && tb.exhausted()) {
      stop_x = 0;
      stop_y = my;
      break;
    }
    uint8_t left_nnz[9] = {};
    for (int mx = 0; mx < mbw_; ++mx) {
      MbInfo& m = mb(mx, my);
      read_modes(b, m, mx, my, &segmap[size_t(my) * mbw_ + mx]);
      const bool y2 = m.ymode != B_PRED && m.ymode != SPLITMV;
      std::memset(coef_, 0, sizeof(coef_));
      uint8_t* top = &top_nnz[size_t(mx) * 9];
      if (!m.skip) {
        if (!webp && tb.exhausted()) {
          stop_x = mx;
          stop_y = my;
          break;
        }
        if (!read_tokens(tb, m, top, left_nnz)) m.skip = 1;
      } else {
        std::memset(top, 0, 8);
        std::memset(left_nnz, 0, 8);
        if (y2) top[8] = left_nnz[8] = 0;
      }
      reconstruct(m, mx, my);
      // the loop filter's level and whether it filters inner edges
      int level = filter_level_;
      if (seg_.enabled)
        level = seg_.lf[m.segment] + (seg_.absolute ? 0 : filter_level_);
      if (lf_.enabled) {
        level += lf_.ref[m.ref];
        if (m.ymode == B_PRED)
          level += lf_.mode[0];
        else if (m.ymode == ZEROMV)
          level += lf_.mode[1];
        else if (m.ymode == SPLITMV)
          level += lf_.mode[3];
        else if (m.ymode >= NEARESTMV)
          level += lf_.mode[2];
      }
      lf_level_[size_t(my) * mbw_ + mx] =
          static_cast<uint8_t>(std::clamp(level, 0, 63));
      lf_inner_[size_t(my) * mbw_ + mx] = !y2 || !m.skip;
      // libwebp's VP8DecodeMB: "Premature end-of-file encountered."
      if (webp && tb.libwebp_eof()) corrupt("a token partition ran out");
    }
    // libwebp's VP8ParseIntraModeRow: "Premature end-of-partition0"
    if (webp && stop_x < 0 && b.libwebp_eof()) corrupt("partition 0 ran out");
  }
  if (stop_x >= 0 && refs_[1]) conceal(stop_x, stop_y);
  if (filter_level_) loop_filter(stop_y);

  // the references
  const FramePtr old[4] = {cur_, refs_[1], refs_[2], refs_[3]};
  refs_[2] = old[golden_src];
  refs_[3] = old[altref_src];
  if (update_last) refs_[1] = cur_;
  segmap_.swap(segmap);
  have_key_ = true;
  if (!refresh_probs) probs_ = saved_;
  if (!show) return kNoFrame;
  shown = cur_;
  return kFrame;
}

// The header from segmentation to the number of token partitions.
void Decoder::frame_header(Bool& b) {
  seg_.enabled = b.get(128);
  if (seg_.enabled) {
    seg_.update_map = b.get(128);
    if (b.get(128)) {  // update_segment_feature_data
      seg_.absolute = b.get(128);
      for (int& q : seg_.quant) q = b.signed_literal(7);
      for (int& l : seg_.lf) l = b.signed_literal(6);
    }
    if (seg_.update_map)
      for (auto& t : seg_.tree)
        t = static_cast<uint8_t>(b.get(128) ? b.literal(8) : 255);
  } else {
    seg_.update_map = false;
  }
  filter_simple_ = b.get(128);
  filter_level_ = b.literal(6);
  sharpness_ = b.literal(3);
  lf_.enabled = b.get(128);
  if (lf_.enabled && b.get(128)) {  // mode_ref_lf_delta_update
    for (int& d : lf_.ref)
      if (b.get(128)) {
        d = b.literal(6);
        if (b.get(128)) d = -d;
      }
    for (int& d : lf_.mode)
      if (b.get(128)) {
        d = b.literal(6);
        if (b.get(128)) d = -d;
      }
  }
  nparts_ = 1 << b.literal(2);
}

void Decoder::read_modes(Bool& b, MbInfo& m, int mx, int my, uint8_t* seg) {
  if (seg_.update_map) {
    int bit = b.get(seg_.tree[0]);
    *seg = static_cast<uint8_t>(b.get(seg_.tree[1 + bit]) + 2 * bit);
  }
  m.segment = *seg;
  m.skip = skip_enabled_ ? b.get(prob_skip_) : 0;
  const MbInfo& above = mb(mx, my - 1);
  const MbInfo& leftm = mb(mx - 1, my);
  if (key_) {
    m.ymode = static_cast<uint8_t>(b.tree(kKfYmodeTree, kKfYmodeProb));
    if (m.ymode == B_PRED) {
      for (int i = 0; i < 16; ++i) {
        int a = i < 4 ? above.bmode[i + 12] : m.bmode[i - 4];
        int l = (i & 3) ? m.bmode[i - 1] : leftm.bmode[i + 3];
        m.bmode[i] =
            static_cast<uint8_t>(b.tree(kBmodeTree, kKfBmodeProb[a][l]));
      }
    } else {
      std::memset(m.bmode, kImpliedBmode[m.ymode], 16);
    }
    m.uvmode = static_cast<uint8_t>(b.tree(kUvModeTree, kKfUvModeProb));
    m.ref = 0;
  } else if (b.get(prob_intra_)) {
    m.ref = b.get(prob_last_) ? (b.get(prob_gf_) ? 3 : 2) : 1;
    read_mvs(b, m, mx, my);
  } else {
    m.ymode = static_cast<uint8_t>(b.tree(kYmodeTree, probs_.ymode));
    if (m.ymode == B_PRED)
      for (auto& bm : m.bmode)
        bm = static_cast<uint8_t>(b.tree(kBmodeTree, kBmodeProb));
    m.uvmode = static_cast<uint8_t>(b.tree(kUvModeTree, probs_.uvmode));
    m.ref = 0;
  }
}

Mv Decoder::read_mv(Bool& b) {
  auto component = [&b](const uint8_t* p) {
    int x = 0;
    if (b.get(p[0])) {  // long form
      for (int i = 0; i < 3; ++i) x += b.get(p[9 + i]) << i;
      for (int i = 9; i > 3; --i) x += b.get(p[9 + i]) << i;
      if (!(x & 0xFFF0) || b.get(p[12])) x += 8;
    } else {  // the short tree
      const uint8_t* ps = p + 2;
      int bit = b.get(*ps);
      ps += 1 + 3 * bit;
      x += 4 * bit;
      bit = b.get(*ps);
      ps += 1 + bit;
      x += 2 * bit;
      x += b.get(*ps);
    }
    return (x && b.get(p[1])) ? -x : x;
  };
  Mv v;
  v.y = static_cast<int16_t>(component(probs_.mv[0]));
  v.x = static_cast<int16_t>(component(probs_.mv[1]));
  return v;
}

void Decoder::read_mvs(Bool& b, MbInfo& m, int mx, int my) {
  // find_near_mvs over the macroblocks above, left and above-left (those
  // outside the frame are intra and count for nothing)
  const MbInfo* edge[3] = {&mb(mx, my - 1), &mb(mx - 1, my),
                           &mb(mx - 1, my - 1)};
  Mv near_mv[4];
  int cnt[4] = {0, 0, 0, 0};
  int idx = 0;
  for (int e = 0; e < 3; ++e) {
    const MbInfo& n = *edge[e];
    if (!n.ref) continue;
    Mv v = n.mv;
    int weight = e == 2 ? 1 : 2;
    if (!v.zero()) {
      if (sign_bias_[m.ref] != sign_bias_[n.ref]) {
        v.y = static_cast<int16_t>(-v.y);
        v.x = static_cast<int16_t>(-v.x);
      }
      if (e == 0 || v != near_mv[idx]) near_mv[++idx] = v;
      cnt[idx] += weight;
    } else {
      cnt[0] += weight;
    }
  }
  // the motion vector bounds: the frame plus 16 pixels, in quarter pixels
  auto clamp_mv = [&](Mv v) {
    const int min_x = -64 - 64 * mx, max_x = ((mbw_ - 1 - mx) << 6) + 64;
    const int min_y = -64 - 64 * my, max_y = ((mbh_ - 1 - my) << 6) + 64;
    v.x = static_cast<int16_t>(std::clamp<int>(v.x, min_x, max_x));
    v.y = static_cast<int16_t>(std::clamp<int>(v.y, min_y, max_y));
    return v;
  };
  for (auto& bv : m.bmv) bv = Mv();
  if (!b.get(kModeContexts[cnt[0]][0])) {
    m.ymode = ZEROMV;
    m.mv = Mv();
    return;
  }
  // three distinct vectors: merge the first and last if they are equal
  if (cnt[3] && near_mv[1] == near_mv[3]) cnt[1] += 1;
  if (cnt[2] > cnt[1]) {
    std::swap(cnt[1], cnt[2]);
    std::swap(near_mv[1], near_mv[2]);
  }
  if (!b.get(kModeContexts[cnt[1]][1])) {
    m.ymode = NEARESTMV;
    m.mv = clamp_mv(near_mv[1]);
  } else if (!b.get(kModeContexts[cnt[2]][2])) {
    m.ymode = NEARMV;
    m.mv = clamp_mv(near_mv[2]);
  } else {
    m.mv = clamp_mv(near_mv[cnt[1] >= cnt[0] ? 1 : 0]);  // best_mv
    const int split_cnt = (edge[1]->ymode == SPLITMV) * 2 +
                          (edge[0]->ymode == SPLITMV) * 2 +
                          (edge[2]->ymode == SPLITMV);
    if (b.get(kModeContexts[split_cnt][3])) {
      m.ymode = SPLITMV;
      read_split(b, m, mx, my);
      return;
    }
    m.ymode = NEWMV;
    Mv d = read_mv(b);
    m.mv.y = static_cast<int16_t>(m.mv.y + d.y);
    m.mv.x = static_cast<int16_t>(m.mv.x + d.x);
  }
  for (auto& bv : m.bmv) bv = m.mv;
}

void Decoder::read_split(Bool& b, MbInfo& m, int mx, int my) {
  int part;
  if (!b.get(kMbSplitProb[0]))
    part = 3;  // 4x4
  else if (!b.get(kMbSplitProb[1]))
    part = 2;  // 8x8
  else
    part = b.get(kMbSplitProb[2]);  // 16x8 or 8x16
  const uint8_t* map = kMbSplits[part];
  const MbInfo& above = mb(mx, my - 1);
  const MbInfo& leftm = mb(mx - 1, my);
  const Mv best = m.mv;
  for (int n = 0; n < kMbSplitCount[part]; ++n) {
    int k = 0;
    while (map[k] != n) ++k;  // the partition's first block
    const Mv l = (k & 3) ? m.bmv[k - 1] : leftm.bmv[k + 3];
    const Mv a = k > 3 ? m.bmv[k - 4] : above.bmv[k + 12];
    const uint8_t* p;
    if (l == a)
      p = kSubMvRefProb[l.zero() ? 4 : 3];
    else if (a.zero())
      p = kSubMvRefProb[2];
    else
      p = kSubMvRefProb[l.zero() ? 1 : 0];
    Mv v;
    if (!b.get(p[0])) {
      v = l;
    } else if (!b.get(p[1])) {
      v = a;
    } else if (!b.get(p[2])) {
      v = Mv();
    } else {
      Mv d = read_mv(b);
      v.y = static_cast<int16_t>(best.y + d.y);
      v.x = static_cast<int16_t>(best.x + d.x);
    }
    for (int i = k; i < 16; ++i)
      if (map[i] == n) m.bmv[i] = v;
  }
  m.mv = m.bmv[15];
}

// One block's tokens from position `first`: the position after the last
// one read (0 when the block starts with EOB).
int Decoder::read_block(Bool& b, int type, int ctx, int first, int16_t* out,
                        int dc_q, int ac_q) {
  const uint8_t(*probs)[3][11] = probs_.coef[type];
  int i = first;
  const uint8_t* p = probs[kBands[i]][ctx];
  if (!b.get(p[0])) return 0;  // EOB
  while (true) {
    if (!b.get(p[1])) {  // DCT_0: no EOB may follow
      if (++i == 16) return 16;
      p = probs[kBands[i]][0];
      continue;
    }
    int v;
    if (!b.get(p[2])) {
      v = 1;
      p = probs[kBands[i + 1]][1];
    } else {
      if (!b.get(p[3])) {
        v = b.get(p[4]);
        if (v) v += b.get(p[5]);
        v += 2;
      } else if (!b.get(p[6])) {
        if (!b.get(p[7])) {
          v = 5 + b.get(kCat1[0]);
        } else {
          v = 7 + (b.get(kCat2[0]) << 1);
          v += b.get(kCat2[1]);
        }
      } else {
        int x = b.get(p[8]);
        int cat = (x << 1) + b.get(p[9 + x]);
        v = 3 + (8 << cat);
        int extra = 0;
        for (const uint8_t* q = kCatProbs[cat]; *q; ++q)
          extra = (extra << 1) + b.get(*q);
        v += extra;
      }
      p = probs[kBands[i + 1]][2];
    }
    if (b.get(128)) v = -v;
    out[kZigzag[i]] = static_cast<int16_t>(v * (i ? ac_q : dc_q));
    if (++i == 16 || !b.get(p[0])) return i;
  }
}

// The macroblock's coefficients; false when it has none.
bool Decoder::read_tokens(Bool& b, MbInfo& m, uint8_t* top, uint8_t* left) {
  const Quant& q = quant_[seg_.enabled ? m.segment : 0];
  int total = 0, first = 0, ytype = 3;
  if (m.ymode != B_PRED && m.ymode != SPLITMV) {
    int nz = read_block(b, 1, top[8] + left[8], 0, coef_[24], q.y2_dc,
                        q.y2_ac);
    top[8] = left[8] = nz > 0;
    total += nz;
    first = 1;
    ytype = 0;
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int nz = read_block(b, ytype, top[x] + left[y], first,
                          coef_[4 * y + x], q.y_dc, q.y_ac);
      top[x] = left[y] = nz > 0;
      total += nz;
    }
  for (int c = 0; c < 2; ++c)  // U, then V
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        uint8_t& t = top[4 + 2 * c + x];
        uint8_t& l = left[4 + 2 * c + y];
        int nz = read_block(b, 2, t + l, 0, coef_[16 + 4 * c + 2 * y + x],
                            q.uv_dc, q.uv_ac);
        t = l = nz > 0;
        total += nz;
      }
  return total > 0;
}

void Decoder::reconstruct(const MbInfo& m, int mx, int my) {
  if (m.ymode != B_PRED && m.ymode != SPLITMV && any(coef_[24]))
    inverse_wht(coef_[24], coef_);
  Frame& f = *cur_;
  if (m.ref)
    inter(m, mx, my);
  else {
    intra_luma(m, mx, my);
    intra_chroma(m, mx, my);
  }
  if (m.ymode != B_PRED) {  // B_PRED added its residual block by block
    uint8_t* y = &f.y[size_t(my) * 16 * f.w + mx * 16];
    for (int i = 0; i < 16; ++i)
      if (any(coef_[i]))
        idct_add(coef_[i], y + (i >> 2) * 4 * f.w + (i & 3) * 4, f.w);
  }
  const int cw = f.w / 2;
  for (int c = 0; c < 2; ++c) {
    uint8_t* d = &(c ? f.v : f.u)[size_t(my) * 8 * cw + mx * 8];
    for (int i = 0; i < 4; ++i)
      if (any(coef_[16 + 4 * c + i]))
        idct_add(coef_[16 + 4 * c + i], d + (i >> 1) * 4 * cw + (i & 1) * 4,
                 cw);
  }
}

void Decoder::intra_luma(const MbInfo& m, int mx, int my) {
  Frame& f = *cur_;
  const int S = f.w, x0 = mx * 16, y0 = my * 16;
  uint8_t* dst = &f.y[size_t(y0) * S + x0];
  if (m.ymode != B_PRED) {
    uint8_t A[16], L[16];
    for (int i = 0; i < 16; ++i) {
      A[i] = my ? dst[i - S] : 127;
      L[i] = mx ? dst[i * S - 1] : 129;
    }
    int P = !my ? 127 : (!mx ? 129 : dst[-S - 1]);
    predict_mb(m.ymode, 16, A, L, P, my > 0, mx > 0, dst, S);
    return;
  }
  // the macroblock's above-right, which the right column of subblocks
  // uses on every row: the row above (replicated past the last column)
  uint8_t tr[4];
  for (int k = 0; k < 4; ++k)
    tr[k] = !my ? 127
                : (mx == mbw_ - 1 ? dst[-S + 15] : dst[-S + 16 + k]);
  for (int i = 0; i < 16; ++i) {
    const int bx = i & 3, by = i >> 2;
    const int px = x0 + 4 * bx, py = y0 + 4 * by;
    uint8_t* d = &f.y[size_t(py) * S + px];
    uint8_t edge[9];  // the corner, above, above-right
    uint8_t* A = edge + 1;
    uint8_t L[4];
    for (int k = 0; k < 4; ++k) {
      A[k] = py ? d[k - S] : 127;
      L[k] = px ? d[k * S - 1] : 129;
      if (bx == 3)
        A[4 + k] = tr[k];
      else
        A[4 + k] = py ? d[4 + k - S] : 127;
    }
    edge[0] = !py ? 127 : (!px ? 129 : d[-S - 1]);
    predict4(m.bmode[i], A, L, d, S);
    if (any(coef_[i])) idct_add(coef_[i], d, S);
  }
}

void Decoder::intra_chroma(const MbInfo& m, int mx, int my) {
  Frame& f = *cur_;
  const int S = f.w / 2;
  for (int c = 0; c < 2; ++c) {
    uint8_t* dst = &(c ? f.v : f.u)[size_t(my) * 8 * S + mx * 8];
    uint8_t A[8], L[8];
    for (int i = 0; i < 8; ++i) {
      A[i] = my ? dst[i - S] : 127;
      L[i] = mx ? dst[i * S - 1] : 129;
    }
    int P = !my ? 127 : (!mx ? 129 : dst[-S - 1]);
    predict_mb(m.uvmode, 8, A, L, P, my > 0, mx > 0, dst, S);
  }
}

void Decoder::inter(const MbInfo& m, int mx, int my) {
  const Frame& r = *refs_[m.ref];
  Frame& f = *cur_;
  const int S = f.w, CS = f.w / 2, ch = f.h / 2;
  const int x0 = mx * 16, y0 = my * 16;
  // luma: per 4x4 block in SPLITMV (the same vector within a partition
  // gives the same pixels as a larger block), else the macroblock
  if (m.ymode == SPLITMV) {
    for (int i = 0; i < 16; ++i) {
      const Mv& v = m.bmv[i];
      int x = x0 + 4 * (i & 3), y = y0 + 4 * (i >> 2);
      predict_inter(r.y.data(), S, f.h, x + (v.x >> 2), y + (v.y >> 2), 4, 4,
                    (v.x & 3) * 2, (v.y & 3) * 2, sixtap_,
                    &f.y[size_t(y) * S + x], S);
    }
  } else {
    const Mv& v = m.mv;
    predict_inter(r.y.data(), S, f.h, x0 + (v.x >> 2), y0 + (v.y >> 2), 16,
                  16, (v.x & 3) * 2, (v.y & 3) * 2, sixtap_,
                  &f.y[size_t(y0) * S + x0], S);
  }
  // chroma: 4x4 blocks with the rounded average of their four luma
  // vectors; the macroblock's vector (in eighths of a chroma pixel)
  for (int j = 0; j < 4; ++j) {
    Mv v;
    const int bx = j & 1, by = j >> 1;
    if (m.ymode == SPLITMV) {
      int sy = 0, sx = 0;
      for (int k = 0; k < 4; ++k) {
        const Mv& b = m.bmv[(2 * by + (k >> 1)) * 4 + 2 * bx + (k & 1)];
        sy += b.y;
        sx += b.x;
      }
      v.y = static_cast<int16_t>((sy + 2 + (sy >> 31)) >> 2);
      v.x = static_cast<int16_t>((sx + 2 + (sx >> 31)) >> 2);
    } else {
      v = m.mv;
    }
    int vy = v.y, vx = v.x;
    if (fullpel_chroma_) {
      vy &= ~7;
      vx &= ~7;
    }
    const int x = mx * 8 + 4 * bx, y = my * 8 + 4 * by;
    predict_inter(r.u.data(), CS, ch, x + (vx >> 3), y + (vy >> 3), 4, 4,
                  vx & 7, vy & 7, sixtap_, &f.u[size_t(y) * CS + x], CS);
    predict_inter(r.v.data(), CS, ch, x + (vx >> 3), y + (vy >> 3), 4, 4,
                  vx & 7, vy & 7, sixtap_, &f.v[size_t(y) * CS + x], CS);
  }
}

// The macroblocks from (mx, my) on in raster order, copied from the last
// frame.
void Decoder::conceal(int mx, int my) {
  const Frame& src = *refs_[1];
  Frame& f = *cur_;
  for (; my < mbh_; ++my, mx = 0) {
    const size_t y0 = size_t(my) * 16 * f.w + mx * 16;
    for (int j = 0; j < 16; ++j)
      std::memcpy(&f.y[y0 + j * f.w], &src.y[y0 + j * f.w], (mbw_ - mx) * 16);
    const size_t c0 = size_t(my) * 8 * (f.w / 2) + mx * 8;
    for (int j = 0; j < 8; ++j) {
      const size_t o = c0 + j * (f.w / 2);
      std::memcpy(&f.u[o], &src.u[o], (mbw_ - mx) * 8);
      std::memcpy(&f.v[o], &src.v[o], (mbw_ - mx) * 8);
    }
  }
}

// The loop filter of the macroblock rows above `rows`.
void Decoder::loop_filter(int rows) {
  Frame& f = *cur_;
  const int S = f.w, CS = f.w / 2;
  for (int my = 0; my < rows; ++my)
    for (int mx = 0; mx < mbw_; ++mx) {
      const int level = lf_level_[size_t(my) * mbw_ + mx];
      if (!level) continue;
      const bool inner = lf_inner_[size_t(my) * mbw_ + mx];
      int interior = level;
      if (sharpness_) {
        interior >>= (sharpness_ + 3) >> 2;
        interior = std::min(interior, 9 - sharpness_);
      }
      interior = std::max(interior, 1);
      const int hev_t = key_ ? (level >= 40 ? 2 : (level >= 15 ? 1 : 0))
                             : (level >= 40 ? 3 : (level >= 20 ? 2 : (level >= 15 ? 1 : 0)));
      const int sub_e = 2 * level + interior, mb_e = sub_e + 4;
      uint8_t* y = &f.y[size_t(my) * 16 * S + mx * 16];
      uint8_t* u = &f.u[size_t(my) * 8 * CS + mx * 8];
      uint8_t* v = &f.v[size_t(my) * 8 * CS + mx * 8];
      if (filter_simple_) {
        if (mx) edge_simple(y, S, 1, 16, mb_e);
        if (inner)
          for (int k = 4; k < 16; k += 4) edge_simple(y + k, S, 1, 16, sub_e);
        if (my) edge_simple(y, 1, S, 16, mb_e);
        if (inner)
          for (int k = 4; k < 16; k += 4)
            edge_simple(y + k * S, 1, S, 16, sub_e);
        continue;
      }
      if (mx) {
        edge_normal(y, S, 1, 16, mb_e, interior, hev_t, true);
        edge_normal(u, CS, 1, 8, mb_e, interior, hev_t, true);
        edge_normal(v, CS, 1, 8, mb_e, interior, hev_t, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4)
          edge_normal(y + k, S, 1, 16, sub_e, interior, hev_t, false);
        edge_normal(u + 4, CS, 1, 8, sub_e, interior, hev_t, false);
        edge_normal(v + 4, CS, 1, 8, sub_e, interior, hev_t, false);
      }
      if (my) {
        edge_normal(y, 1, S, 16, mb_e, interior, hev_t, true);
        edge_normal(u, 1, CS, 8, mb_e, interior, hev_t, true);
        edge_normal(v, 1, CS, 8, mb_e, interior, hev_t, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4)
          edge_normal(y + k * S, 1, S, 16, sub_e, interior, hev_t, false);
        edge_normal(u + 4 * CS, 1, CS, 8, sub_e, interior, hev_t, false);
        edge_normal(v + 4 * CS, 1, CS, 8, sub_e, interior, hev_t, false);
      }
    }
}

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0)
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

template <typename A>
int copy_table(const A& t, int32_t* out, int cap) {
  using E = std::remove_all_extents_t<A>;
  const E* p = reinterpret_cast<const E*>(&t);
  const int n = static_cast<int>(sizeof(A) / sizeof(E));
  if (out)
    for (int i = 0; i < std::min(n, cap); ++i) out[i] = p[i];
  return n;
}

}  // namespace

// libwebp's output stage for lossy images (src/dsp/yuv.h, upsampling.c,
// src/dec/io_dec.c EmitFancyRGB): each chroma sample is upsampled by the
// 9-3-3-1 "fancy" filter, the first and last rows and columns mirrored,
// and converted with VP8YUVToR/G/B's 14-bit constants.
namespace webp_rgb {

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

inline uint8_t clip8(int v) {
  return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6)
                           : (v < 0 ? 0 : 255);
}

inline void put(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320)
                 + 8708);
  rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: the rows top_y (and bot_y, if not null) of len
// pixels between the chroma rows top_* and cur_*; u and v travel packed
// in one word, as in libwebp.
void line_pair(const uint8_t* top_y, const uint8_t* bot_y,
               const uint8_t* top_u, const uint8_t* top_v,
               const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst,
               uint8_t* bot_dst, int len) {
  auto load = [](uint8_t u, uint8_t v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    put(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bot_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    put(bot_y[0], uv0 & 0xff, (uv0 >> 16), bot_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      put(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (2 * x - 1) * 3);
      put(top_y[2 * x], uv1 & 0xff, (uv1 >> 16), top_dst + (2 * x) * 3);
    }
    if (bot_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      put(bot_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), bot_dst + (2 * x - 1) * 3);
      put(bot_y[2 * x], uv1 & 0xff, (uv1 >> 16), bot_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      put(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * 3);
    }
    if (bot_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      put(bot_y[len - 1], uv0 & 0xff, (uv0 >> 16), bot_dst + (len - 1) * 3);
    }
  }
}

// EmitFancyRGB over the whole picture: row 0 against its own chroma row,
// then rows (2k-1, 2k) between chroma rows k-1 and k, and at an even
// height the last row against the last chroma row alone.
void to_rgb(const uint8_t* y, int ys, const uint8_t* u, const uint8_t* v,
            int cs, int w, int h, uint8_t* rgb) {
  const int64_t row = int64_t(w) * 3;
  line_pair(y, nullptr, u, v, u, v, rgb, nullptr, w);
  int k = 1;
  for (; 2 * k < h; ++k)
    line_pair(y + int64_t(2 * k - 1) * ys, y + int64_t(2 * k) * ys,
              u + int64_t(k - 1) * cs, v + int64_t(k - 1) * cs,
              u + int64_t(k) * cs, v + int64_t(k) * cs,
              rgb + (2 * k - 1) * row, rgb + (2 * k) * row, w);
  if (!(h & 1) && h > 1) {
    const int64_t c = int64_t(h / 2 - 1) * cs;
    line_pair(y + int64_t(h - 1) * ys, nullptr, u + c, v + c, u + c, v + c,
              rgb + (h - 1) * row, nullptr, w);
  }
}

}  // namespace webp_rgb

extern "C" {

// A decoder (no headers: a VP8 stream carries them in its key frames).
void* vp8dec_open() { return new Decoder(); }

// Decode one frame.  0: a frame, *w and *h set (one whose token data
// ended early too); 1: no frame (show_frame 0); 2: a feature it does not
// decode (msg names it); 3: a corrupt or truncated header, or an inter
// frame before the first key frame (no frame; the references stay).
int vp8dec_decode(void* handle, const uint8_t* data, int64_t n, int* w,
                  int* h, char* msg, int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  try {
    Status st = d->decode(data, n);
    *w = d->width;
    *h = d->height;
    return st;
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  } catch (const std::bad_alloc&) {
    put_msg("out of memory", msg, msg_len);
    return kCorrupt;
  }
}

// Decode a lossy WebP photo's key frame as libwebp's vp8_dec.c refuses one
// (1) or as a video frame as FFmpeg reads it (0, the default): libwebp
// takes a token partition whose size runs past the data as the rest of it,
// needs the last partition to hold a byte, ignores clamping_type, and
// gives no image where the header, partition 0 or a macroblock's tokens
// need a byte past their partition.
void vp8dec_set_webp(void* handle, int on) {
  static_cast<Decoder*>(handle)->webp = on != 0;
}

// The last frame given as h*w*3 RGB bytes.  0: done; 4: cap too small.
int vp8dec_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->shown || int64_t(d->width) * d->height * 3 > cap) return kSmall;
  const Frame& f = *d->shown;
  swscale_rgb::to_rgb(f.y.data(), f.w, f.u.data(), f.v.data(), f.w / 2,
                      d->width, d->height, rgb);
  return kFrame;
}

// The last frame as h*w*3 RGB bytes the way libwebp outputs a lossy WebP
// (the still-image use of VP8): its "fancy" chroma upsampler and its
// 14-bit YUV->RGB (webp_rgb below).  0: done; 4: cap too small.
int vp8dec_webp_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->shown || int64_t(d->width) * d->height * 3 > cap) return kSmall;
  const Frame& f = *d->shown;
  webp_rgb::to_rgb(f.y.data(), f.w, f.u.data(), f.v.data(), f.w / 2,
                   d->width, d->height, rgb);
  return kFrame;
}

// The last frame's I420 planes, cropped: y (h*w), u and v
// (ceil(h/2)*ceil(w/2) each).  0: done; 4: a cap too small.
int vp8dec_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                  int64_t ycap, int64_t ccap) {
  Decoder* d = static_cast<Decoder*>(handle);
  int w = d->width, h = d->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  if (!d->shown || int64_t(w) * h > ycap || int64_t(cw) * ch > ccap)
    return kSmall;
  const Frame& f = *d->shown;
  for (int j = 0; j < h; ++j)
    std::memcpy(y + int64_t(j) * w, &f.y[size_t(j) * f.w], w);
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + int64_t(j) * cw, &f.u[size_t(j) * (f.w / 2)], cw);
    std::memcpy(v + int64_t(j) * cw, &f.v[size_t(j) * (f.w / 2)], cw);
  }
  return kFrame;
}

void vp8dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

// The entries of one of the decoder's constant tables, flattened in C
// order, into out[0..cap); the number of entries, or -1 for another name.
int vp8dec_table(const char* name, int32_t* out, int cap) {
  const std::string n(name);
  if (n == "dc_qlookup") return copy_table(kDcQ, out, cap);
  if (n == "ac_qlookup") return copy_table(kAcQ, out, cap);
  if (n == "coeff_default_probs") return copy_table(kCoefDefault, out, cap);
  if (n == "coeff_update_probs") return copy_table(kCoefUpdate, out, cap);
  if (n == "kf_bmode_probs") return copy_table(kKfBmodeProb, out, cap);
  if (n == "mv_default_probs") return copy_table(kMvDefault, out, cap);
  if (n == "mv_update_probs") return copy_table(kMvUpdate, out, cap);
  if (n == "mode_contexts") return copy_table(kModeContexts, out, cap);
  if (n == "sub_mv_ref_probs") return copy_table(kSubMvRefProb, out, cap);
  if (n == "bmode_probs") return copy_table(kBmodeProb, out, cap);
  if (n == "subpel_filters") return copy_table(kSubpel, out, cap);
  if (n == "zigzag") return copy_table(kZigzag, out, cap);
  if (n == "cat6_probs") return copy_table(kCat6, out, cap) - 1;
  return -1;
}

}  // extern "C"
