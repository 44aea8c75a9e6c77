#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by one flushed line with the elapsed seconds:

1. card     — name and power limit (nvidia-smi); fails without CUDA.
2. build    — every kernel source of the port, one nvcc per source, all
              started together; prints nvcc's register/shared-memory/spill
              report, and counts the tensor-core (HMMA) instructions that
              ``cuobjdump -sass`` shows in the L2/Hamming tile of both
              libraries that carry it (fails on none).
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, at the main path's shapes and at ragged/edge shapes
              (and ``top2_batch`` with metric "hamming" at ORB's shapes, and
              at D=384 at FHD and at the 4K point, held lane by lane),
              with the tolerances stated below; CUDA-event times of both
              (warm-up, then the median of 20) beside the bound and beside
              the two-call library yardstick (cdist + topk).
4. main     — the port's ``slam_main`` on CUDA with the headline
              configuration (FHD 1080x1920, SIFT, L2 2-NN, PnP-RANSAC,
              windowed Huber BA, ``ingest="device"``) over a synthetic
              hallway rendered from a seed; launch counts reset just before
              and read just after; checks cameras, state placement and ATE
              against ground truth.
5. l1       — the same frames and configuration through ``DeviceEngine.run``
              with ``EngineConfig.metric="l1"`` (the reference CUDA
              backend's NORM_L1 matcher): every scan step through
              ``top2_l1``, none through ``top2_batch``.
6. orb      — ``slam_main`` with only ``useFM-ORB`` set: ORB descriptors
              (int32 bit words), every scan step through ``top2_batch`` with
              metric "hamming".
7. global   — the headline with ``tpu.global_ba`` (8 LM iterations of 12
              CG steps, the config's defaults): the final global BA's RMSE
              before and after, whether it was accepted, its solve time, and
              the ATE before and after it.
8. resume   — the headline with ``tpu.checkpoint_path``/``checkpoint_every``
              crashes after its first snapshot; a second ``slam_main`` with
              ``tpu.resume_path`` continues it, and must give phase 4's
              cameras, poses and map bit for bit.
9. stream   — the headline with ``tpu.ingest="host"``,
              ``host_descriptor="same"`` and ``streaming`` (the pooled gray
              at d=2, the JAX default): FAST on the host in the packer
              threads, ``steps.advance_stream`` on the card.  Checks cameras,
              ATE and state placement as phase 4 does, and that
              ``top2_batch`` ran once per active scan step plus once per
              bootstrap ``match_select``, and no other kernel ran; prints
              the wall, frames/s, the host ingest ms per frame and the
              number of ``advance_stream`` calls.
10. hybrid  — the stream phase's configuration with the JAX default host
              descriptor, "auto": it must resolve to "hybrid" (pooled SIFT
              from the d=2 gray beside the host's full-resolution ORB bits,
              α = 0.08, D = 384); cameras and ATE as phase 4, one L2
              ``top2_batch`` launch per active scan step and bootstrap
              match, and a ring slot whose last 256 columns equal α times
              the uploaded bits; ``top2_batch`` then held to its plain
              version on the ring's own descriptors; prints the host ingest
              per frame (gray, FAST, ORB, pooling) and the tracking per
              frame.
11. hostorb — ``useFM-ORB`` under host ingest with "auto": it must resolve to
              "orb" (the host's ORB words matched by Hamming), pack and
              upload no gray plane, track as phase 4 and launch the
              Hamming ``top2_batch`` once per active scan step and bootstrap
              match; the kernel is timed and held exactly on the ring's
              host words (a kernel row of its own).
12. pair    — ``knn.match_pair`` on CUDA with the SIFT descriptors of two
              rendered frames: one ``top2_pair`` launch, the same matches as
              ``match_pair`` on CPU copies up to the rows the L2 tolerance
              leaves open.
13. classic — ``slam_main`` with ``tpu.device_runtime=false``: the classic
              host conductor (pipeline/) on the headline configuration, one
              ``top2_batch`` launch per matched ``find_good_frame`` scan
              (B = the batch's length, 1..16), the descriptors on the card,
              no other kernel; cameras and ATE as phase 4.
14. telemetry — the headline with ``per_frame_telemetry``: one step per
              ``advance_window`` call, one "Matching time for index" line
              in time.txt per scan step, one ``top2_batch`` launch per scan
              step (and per bootstrap ``match_select``); prints whether it
              equals phase 4 bit for bit and where the two part.
15. cli     — the 32 frames written as PNG files (numpy + zlib), K as XML,
              the configuration as JSON, then ``python3 -m
              slam_indoor_code_tpu_torch cfg.json --profile DIR`` as a
              subprocess: exit 0, the "map points" line, the six logs
              reloaded with its cameras at ATE < 5 %, a trace in DIR that
              names ``top2_l2_kernel`` and ``steps.`` spans; prints the
              photo decode ms per frame and which decoder ran.
    fixture-clis — the CLI on each glob and video of phases 16-25 and
              34, one run after another in one subprocess under a counting
              wrapper (each with the jpeg phase's checks, its counts set to
              0 before it and 600 s of its own), which pays the
              interpreter's, PyTorch's and the card's start once: lossless
              first (a cold run, as a user's), then jpeg, video, progjpeg,
              tiffjpeg, jp2, mp4, asp, webm, vp9, mpeg2, h263, flv, mpng and
              the photos glob (warm), then lossless again (warm, to measure
              what the shared process saves); each phase below holds its
              run and prints whether it was cold or warm.  The JPEG files,
              AVI, progressive JPEGs and JPEG TIFFs of phases 16-18a, the
              photos glob (phase 34's, written on three threads) and the
              mpng AVI are written before it.
16. jpeg    — the 32 frames as baseline 4:2:0 JPEG at quality 95 (the
              numpy writer of testing/mjpeg.py: the card has no encoder),
              the CLI module on them (three decode workers, its run in
              fixture-clis): exit 0, the "map points" line, the logs
              reloaded with cameras >= 24/32 at ATE < 5 %, one L2
              ``top2_batch`` launch per scan step and bootstrap match and
              no other kernel; io/jpeg.py held to the committed sha256 of
              cv2's decode of the fixtures in testing/jpeg_fixtures/; the
              decode timed with three workers and with one (two passes bit
              for bit) and set beside the tracking ms per frame; prints
              which decoder ran.
17. video   — the same JPEG frames muxed into one MJPEG AVI, the CLI with
              ``usePhotosCycle=false`` (fixture-clis): the jpeg phase's
              checks, poses.txt equal to the jpeg run's byte for byte, the
              AVI's frames equal to the JPEG files'; prints the frame
              count, the container parse time and the decode ms per
              frame.
18. progjpeg — first the small committed video fixtures
              (testing/video_fixtures/: video packets, an Xvid-tagged
              stream, odd heights in VP8 and I420, Y800, MJPEG in MOV) held
              through ``MediaSource`` to the committed sha256 of cv2's
              decode, and the progressive JPEG fixtures among
              testing/jpeg_fixtures/ (counted); then the 32 frames as
              progressive JPEG at quality 95 in libjpeg's default scan
              script (the numpy writer of testing/mjpeg.py, the same
              coefficients as the jpeg phase's), the CLI on the photo glob
              (fixture-clis): the jpeg phase's checks, poses.txt equal to
              the jpeg run's byte for byte where every decoded frame equals
              the baseline one (else where they part); prints the decode ms
              per FHD frame with three workers and with one beside the
              tracking ms per frame.
18a. tiffjpeg — the jpeg phase's JPEGs as one-strip YCbCr JPEG TIFFs
              (testing/photos.encode_tiff: JPEGTables and abbreviated
              strips): each decoded by io/tiff.py on one thread, equal to
              the port's decode of the same JPEG bit for bit; the CLI on
              the glob (fixture-clis): the jpeg phase's checks, poses.txt
              equal to the jpeg run's byte for byte and its ``top2_batch``
              launches; prints the decode ms per FHD frame beside the
              tracking ms per frame.
18c. damaged — the committed damaged FHD frames of
              testing/jpeg_fixtures/damaged/ (frames 8, 16, 24 and 31 of the
              render from the numpy writer at q95: cut at 60 %, three
              flipped bits, a restart interval then flips, progressive and
              cut mid-scan) each decoded on one thread, timed, and held to
              the committed sha256 of cv2's decode (libjpeg-turbo's
              recovery, native/jpeg.cpp's ``lenient``); then the jpeg
              phase's glob with those four in place of the same frames
              through ``MediaSource`` (32 frames, none skipped) and the CLI
              (fixture-clis): the jpeg phase's checks; prints the decode ms
              of each damaged frame and the run's launches.
18b. jp2    — the committed fixture testing/photo_fixtures/headline_jp2/
              (the 32 frames as Pillow writes JPEG 2000: 9/7, RPCL,
              1024x1024 tiles, 256x256 precincts, three layers, PLT; 5.9
              MB in all): each frame decoded by io/jp2.py (native/jp2.cpp)
              on one thread, timed and held to the committed sha256 of
              cv2's decode; the CLI on the glob (fixture-clis): the jpeg
              phase's checks; prints the decode ms per FHD frame beside the
              tracking ms per frame.
19. mp4     — the committed fixture testing/video_fixtures/headline_mp4v.mp4
              (the 32 frames as OpenCV's ``mp4v`` writer makes them; the
              card has no encoder): the container parsed and timed, every
              frame decoded by io/mpeg4.py on one thread and held to the
              committed sha256 of cv2's RGB frames and Y planes (and the
              small AC-prediction/DQUANT fixture to its RGB sha256), the
              samples muxed into an XVID AVI whose frames equal the MP4's,
              then the CLI with ``usePhotosCycle=false`` on the .mp4: the
              jpeg phase's checks; prints the parse time and the decode ms
              per frame beside the tracking ms per frame.
20. asp     — MPEG-4 Advanced Simple Profile: the committed fixture
              testing/video_fixtures/headline_asp_packed.avi (the 32
              frames coded by libavcodec with B-VOPs, 4MV, quarter-pel and
              MPEG quantisation, packed as DivX packs B-VOPs, DX50) and
              eight small ASP fixtures held frame by frame to the committed
              sha256 of cv2's RGB frames and Y planes, in display order;
              the FHD decode timed on one thread; then the CLI with
              ``usePhotosCycle=false`` on the AVI: the jpeg phase's checks;
              prints the decode ms per FHD frame beside the tracking ms per
              frame.
21. webm    — the committed fixture testing/video_fixtures/headline_vp8.webm
              (the 32 frames as OpenCV's ``VP80`` writer makes them): the
              Matroska container parsed and timed, every frame decoded by
              io/vp8.py on one thread and held to the committed sha256 of
              cv2's RGB frames and Y planes, the frames muxed into a VP80
              AVI whose frames equal the WebM's through ``MediaSource``,
              then the CLI with ``usePhotosCycle=false`` on the .webm: the
              jpeg phase's checks; prints the parse time and the decode ms
              per FHD frame beside the tracking ms per frame.
22. vp9     — the committed fixture testing/video_fixtures/headline_vp9.webm
              (the 32 frames coded by libvpx-vp9 in two passes: hidden
              alt-ref frames in superframes, compound prediction, 4 tile
              columns, backward adaptation) and seven small VP9 fixtures
              (cv2's VP90 writer in WebM, AVI and MP4; lossless;
              segmentation; error-resilient; an odd size): the container
              parsed and timed, every FHD frame decoded by io/vp9.py on one
              thread, timed, and held to the committed sha256 of cv2's RGB
              frames and Y planes, the small ones too; the FHD packets
              muxed into a VP90 AVI whose frames equal the WebM's through
              ``MediaSource``; then the CLI with ``usePhotosCycle=false`` on
              the .webm: the jpeg phase's checks; prints the parse time and
              the decode ms per FHD frame beside the tracking ms per frame.
23. mpeg2   — MPEG-2 video in a transport stream: the committed fixture
              testing/video_fixtures/headline_mpeg2.ts (the 32 frames coded
              by libavcodec's mpeg2video as a broadcast or HDV encoder
              codes them: B pictures, open GOPs, field DCT and field
              prediction, alternate scan, B-15 intra VLCs, non-linear
              quantiser scale, 10-bit intra DC, BT.709, with a PAT, a PMT
              and an audio PID beside the video) and nine small fixtures
              (cv2's mpg1 and MPEG writers in .mpg, .avi, .mkv, .mp4 and
              .mov; an M2TS; a VOB-like PAL program stream with navigation
              packs, audio and padding; a transport stream cut mid-GOP):
              the transport stream demuxed and timed, every FHD picture
              decoded by io/mpeg12.py on one thread, timed, and held to the
              committed sha256 of cv2's RGB frames and Y planes (cv2's Y
              read of a BT.709 frame goes through RGB: mpeg12.luma_read),
              the small ones too; the decoder's statistics must show the
              headline's tools; then the CLI with ``usePhotosCycle=false``
              on the .ts: the jpeg phase's checks; prints the demux time
              and the decode ms per FHD frame beside the tracking ms per
              frame.
24. h263    — H.263 in a 3GPP file: the committed fixture
              testing/video_fixtures/headline_h263p.3gp (the 32 frames
              coded by libavcodec's h263p at 1920x1080, a custom picture
              format, with every annex it writes: unrestricted vectors,
              4MV and OBMC, advanced intra coding, deblocking, slices, the
              alternative inter VLC and modified quantisation, at a fixed
              quantiser of 8) and eight small fixtures (cv2's H263 writer
              in .avi, .3gp, .3g2, .mov and .mkv; a 4CIF baseline stream
              with 4MV, OBMC and GOB headers; a raw H.263+ stream with
              every annex at quantiser 2; a U263 AVI): the 3GP demuxed and
              timed, every FHD picture decoded by io/h263.py on one thread,
              timed, and held to the committed sha256 of cv2's RGB frames
              and Y planes, the small ones too; the decoder's counts must
              show each annex in every picture and each annex's tool in
              use; then the CLI with ``usePhotosCycle=false`` on the .3gp:
              the jpeg phase's checks; prints the demux time and the decode
              ms per FHD frame beside the tracking ms per frame.
    flv     — Flash Video: the committed fixture
              testing/video_fixtures/headline_flv1.flv (the 32 frames as
              cv2 decodes headline_mp4v.mp4, coded by libavcodec's flv
              encoder, Sorenson Spark, at a fixed quantiser of 6) and five
              small fixtures (cv2's FLV1 writer in .flv, .avi, .mkv and
              .mov; quantiser 1 with audio and script tags between the
              pictures): demuxed (io/flv.py) and timed, every picture
              decoded by io/h263.py's Sorenson mode on one thread, timed,
              and held to the committed sha256 of cv2's RGB frames and Y
              planes; the counts must show FLV's 7-bit escapes (the
              headline) and 11-bit ones (quantiser 1); then the CLI on the
              .flv: the jpeg phase's checks; prints the demux time and the
              decode ms per FHD frame beside the tracking ms per frame.
    mpng    — PNG as video: the cli phase's 32 PNG files (the same
              writer, the same bytes) muxed on the card into one ``MPNG``
              AVI (testing/mjpeg.py), every frame decoded by io/png.py as
              FFmpeg's png decoder reads it, on one thread, timed, equal to
              the rendered frame; the three small cv2-written MPNG AVI/MKV
              and ``png `` MOV fixtures held to cv2's sha256; then the CLI
              on the AVI: the jpeg phase's checks, poses.txt equal to the
              cli phase's byte for byte and its ``top2_batch`` launches.
25. lossless — FFV1 and HuffYUV: the committed fixture
              testing/video_fixtures/headline_ffv1.mkv (the 32 rendered
              frames through OpenCV's own ``FFV1`` writer: version 3,
              BGRA, Golomb-Rice slices with CRCs) demuxed and timed, every
              frame decoded by io/ffv1.py on one thread, timed, equal to
              the rendered frames (lossless) and to the committed sha256 of
              cv2's decode; nine small FFV1 and HuffYUV fixtures (cv2's
              FFV1 writer in .avi and .mov, its HFYU writer in .avi and
              .mkv, its FFVH writer in .avi; FFV1 level 3 with slice CRCs
              and a custom state table; Golomb-Rice FFV1; huffyuv 4:2:2
              with median prediction; FFVHuff with tables in every frame)
              held to theirs through ``MediaSource``, and the headline's
              first frame through OpenCV's ``FFVH`` writer decoded by
              io/huffyuv.py on one thread, timed; then the CLI run on the
              .mkv (cold): the jpeg phase's checks, and its poses.txt must
              equal phase 4's byte for byte, and its warm repeat's poses.txt
              and launches the cold run's; prints the demux time and the
              decode ms per FHD frame of both codecs beside the tracking ms
              per frame, cold and warm.
26. realtex — testing/realtex.py's two-plane scene at 1080x1920, 24
              frames, two procedural textures from seeds, rendered on the
              card (frame 0 equal to the CPU render), through ``slam_main``
              at the headline configuration: cameras >= 12/24 at ATE < 5 %
              against the scene's exact centres, one L2 ``top2_batch``
              launch per scan step and bootstrap match; prints the render
              ms per frame.
27. calibrate — ``calibrate_camera`` on CUDA over 20 synthetic views of
              the 7x7 board through the headline's FHD K (distortion, 0.1 px
              noise, from a seed): fx and fy within 1 % of the truth, rms
              < 0.3 px, K within 2e-3 relative of the port's CPU result on
              the same views; the XML written and reloaded; the solve's
              seconds.  Then from pixels: 12 FHD views (BOARD_VIEWS)
              rendered on the card by testing/board.py through the same K
              and distortion with noise of 2 gray levels, held host-side
              to the projection (calibration/corners.py: all 12 found,
              corners within median 0.1 / max 0.5 px), a board-free frame
              and a board cut by the frame edge giving None; the views as
              PNG photos and as one MJPEG AVI (each q95 frame, encoded on a
              thread per core, written ten times: the branch takes every
              tenth) through the CLI, the two runs one after the other in
              one subprocess (``calibrate``, default device): exit 0, 12
              views in each XML, fx/fy within 1 %, cx/cy within 1 % of the
              image size, rms < 0.3 px; prints the detection ms per FHD
              photo with and without a board, each branch's K and its
              solve's seconds on the card.  Then the 12 views thresholded
              at 128 as bilevel pages, six as Group 4 and six as Group 3 2D
              with FillOrder 2, written on the host by the numpy writer
              (testing/ccitt.py): each decoded on one thread by io/tiff.py
              (native/fax3.cpp) equal to its thresholded view bit for bit,
              timed; the CLI's calibrate branch on them (the third run of
              the subprocess): exit 0, 12 views in the XML, fx/fy within
              1 %, cx/cy within 1 % of the image size; prints its rms (no
              bound: bilevel corners are not the grey ones).
28. shard   — eight virtual shards on cuda:0: ``ShardedFrontend`` on 16
              FHD frames (two a shard), SIFT/L2 and ORB/Hamming, gives the
              unsplit call's match counts exactly with 8 ``top2_batch``
              launches per call; ``ShardedBA`` at the headline's BA shape
              (8 frames, 4096 window points, Huber 2, 10 LM iterations) is
              held to ``bundle_adjust_window`` with tests/test_parallel.py's
              rule (cams 5e-3, cost 5 %, points 0.15 / median 0.05).
29. mesh    — ``slam_main`` on the headline with ``tpu.mesh_shape=(cards,)``:
              on one card it must equal phase 4 bit for bit.
30. sequences — ``run_sequences_parallel`` on two 32-frame FHD sequences
              (the headline scene and the same hallway from seed 8), one
              thread and CUDA stream each: each equals its own solo run bit
              for bit; prints the parallel wall beside the two solo walls.
31. distributed — two processes of ``parallel/worker.py ba`` (gloo, both
              ranks on cuda:0; NCCL where each has a card) solve
              ``ShardedBA`` across the process boundary at the headline's
              BA shape: final cost within 1e-3 relative and cameras within
              5e-4 of a one-process solve.
32. 4k      — bench.py's 4K operating point (config #4: 2160x3840, 10,240
              keypoints, 8,192 window points, 256 PnP hypotheses, d=4,
              hybrid at α = 0.15, the global BA, ratio 0.70) under host
              ingest on 16 frames (two BA windows; cut from 48): at least
              12/16 cameras at ATE < 5 %, one L2 ``top2_batch`` launch per
              active scan step and bootstrap match; prints the host ingest
              per frame and its parts, the tracking per frame, the kernel's
              time per call at [10240,384] x [16,10240,384], the ring's size
              and the peak device memory; ``top2_batch`` then held to its
              plain version, lane by lane, on the 4K ring.
33. repro   — phases 4, 5, 6, 9, 13 and 10 once more in the same process:
              each second run must give the first run's cameras, map size,
              poses and map points bit for bit (the second stream, classic
              and hybrid runs are the warm ones).
34. photos  — the photo readers the card has (io/photo.py: no libjpeg,
              libpng, libtiff, libwebp, giflib or OpenCV): first every
              committed fixture in testing/photo_fixtures/ (one per PNG,
              PNM, BMP, TIFF (with JPEG, YCbCr, CMYK and CIE Lab), JPEG
              2000, lossy, lossless and animated WebP, GIF, PFM, Radiance
              HDR and Sun raster variant family and EXIF case; a damaged
              lossy WebP, a run-length coded Sun raster, a float TIFF and
              an offset JP2 that cv2 refuses give no frame) through
              ``MediaSource``, held to the
              committed sha256 of cv2's decode; then the 32 frames written
              by testing/photos.py as one glob cycling P6 PPM, 24-bit BMP,
              tiled Deflate TIFF with the predictor, PackBits TIFF strips,
              16-bit PNG (x257), all-Paeth PNG, lossless WebP, animated
              lossless WebP, 24-bit Sun raster and CMYK TIFF with K = 0
              (lossless: C, M, Y = 255 - R, G, B), names of one length,
              written on three threads before fixture-clis: every decoded
              frame equal to the rendered one, then the CLI on the glob
              (its run in fixture-clis's subprocess, three decode workers):
              exit 0, 32/32 cameras, poses.txt equal to the cli phase's
              byte for byte, the cli phase's ``top2_batch`` launches and no
              other kernel; the first frame as PFM (equal to it) and as
              Radiance HDR (its RGBE rounding, within 1 grey level) decoded
              and timed on one thread; the jpeg phase's first frame with an
              EXIF
              Orientation 6 APP1 must decode to the untagged decode turned
              a quarter clockwise (as cv2 turns it); four frames quantised
              to a fixed 256-entry palette and written as GIF must decode
              to palette[index] exactly (a palette changes the frames, so
              GIF stays out of the glob); prints the decode ms per FHD
              frame of each format on one thread and with three workers
              beside the tracking ms per frame.

No path may call a kernel's plain version on the card (each phase counts
those calls and fails on any).

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds.  The f32
# peak counts an FMA as two operations; a plain add or subtract retires at
# half that rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BIG = 3.0e38

# Headline configuration (the JAX package's bench.py, pinned to device
# ingest) and its synthetic scene.  Every path is held to the same limits:
# the JAX package's L1, L2 and ORB engines on these 32 frames (CPU runs,
# scripts/headline_cpu.py) track 32/32 frames well inside them.
N_FRAMES = 32
MIN_CAMERAS = 24
ATE_MAX_FRAC = 0.05


def headline_config(out_dir: str):
    """The JAX package's bench.py headline configuration, ingest pinned to
    the device: FHD, SIFT, L2 ratio 0.8, 2048 keypoints, batch 16, 80
    required matches, 1024/64 RANSAC hypotheses, 4096 window points, Huber
    BA every 8 frames with 10 LM iterations, no global BA."""
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig

    return Config(
        usePhotosCycle=True, outputDataDir=out_dir,
        requiredExtractedPointsCount=300, featureExtractingThreshold=20,
        framesBatchSize=16, requiredMatchedPointsCount=80,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=8,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        tpu=TpuConfig(max_keypoints=2048, ransac_iters=1024,
                      pnp_ransac_iters=64, window_points=4096,
                      ba_max_iters=10, global_ba=False, ingest="device"))


def orb_config(out_dir: str):
    """The headline configuration with only ``useFM-ORB`` set: ORB
    descriptors and Hamming 2-NN."""
    return dataclasses.replace(headline_config(out_dir), useFM_SIFT_BF=False,
                               useFM_SIFT_FLANN=False, useFM_ORB=True)


def stream_config(out_dir: str):
    """The headline configuration under host ingest: FAST on the host,
    the pooled gray (d=2) uploaded, "same" descriptors on the device, the
    streaming loop."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, ingest="host", host_descriptor="same", streaming=True,
        ingest_downscale=2))


def hybrid_config(out_dir: str):
    """``stream_config`` with the JAX package's default host descriptor,
    "auto": under host ingest a SIFT configuration takes "hybrid" (pooled
    SIFT from the d=2 gray beside the host's full-resolution ORB bits,
    α = 0.08, one 384-dim L2 descriptor)."""
    cfg = stream_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, host_descriptor="auto", hybrid_alpha=0.08))


def hostorb_config(out_dir: str):
    """``orb_config`` under host ingest with host descriptor "auto", which
    an ORB configuration takes as "orb": the host's ORB bits are the
    descriptors, matched by Hamming; no gray plane is uploaded."""
    cfg = orb_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, ingest="host", host_descriptor="auto", streaming=True,
        ingest_downscale=2))


# The JAX package's 4K operating point (bench.py config #4) on its
# slow-link path, cut from 48 frames to 16 (two BA windows); widths uncut.
N_FRAMES_4K = 16
MIN_CAMERAS_4K = 12


def fourk_config(out_dir: str):
    """bench.py's config #4: 2160x3840, 10,240 keypoints, 8,192 window
    points, 256 PnP hypotheses, the pooled gray at d=4 with hybrid
    descriptors at α = 0.15, the final global BA, ratio 0.70, 500 required
    matches, 1000 required corners; host ingest pinned (the path the JAX
    4K point ran on its slow link), the streaming loop."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(
        cfg, requiredMatchedPointsCount=500,
        requiredExtractedPointsCount=1000, knnMatcherDistance=0.70,
        tpu=dataclasses.replace(
            cfg.tpu, max_keypoints=10240, window_points=8192,
            pnp_ransac_iters=256, ingest="host", host_descriptor="auto",
            ingest_downscale=4, hybrid_alpha=0.15, global_ba=True,
            streaming=True))


def fourk_scene(n_frames: int = N_FRAMES_4K):
    """bench.py's 4K scene: the hallway at 2160x3840, 4000 points, seed
    13."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=4000, n_frames=n_frames,
                       image_size=(2160, 3840), seed=13, baseline=0.25,
                       kind="hallway")
    return scene, [scene.render(i) for i in range(n_frames)]


def headline_scene(n_frames: int = N_FRAMES, seed: int = 7):
    """The benchmark's synthetic FHD hallway (seed 7) and its frames."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=n_frames,
                       image_size=(1080, 1920), seed=seed, baseline=0.25,
                       kind="hallway")
    return scene, [scene.render(i) for i in range(n_frames)]


def phase(name: str, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{time.perf_counter() - T0:8.2f} s] {name} done {fields}",
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc={smi.returncode})"
    print(line, flush=True)
    return torch.cuda.get_device_name(0), line


def build():
    from slam_indoor_code_tpu_torch.ops import build as kb

    t = time.perf_counter()
    libs = kb.build_all(force=True)
    for stem, info in libs.items():
        for ln in info["log"].splitlines():
            if any(k in ln for k in ("registers", "spill", "smem", "Compiling")):
                print(f"  {stem}: {ln.strip()}", flush=True)
    return time.perf_counter() - t


def tensor_core_instructions() -> dict:
    """HMMA instructions in top2_l2_kernel of the two libraries that carry
    the L2/Hamming tile, from ``cuobjdump -sass`` (beside nvcc).  Fails
    where there are none: the tile's product must run on the tensor
    cores."""
    from pathlib import Path

    from slam_indoor_code_tpu_torch.ops import build as kb

    tool = Path(kb.nvcc_path()).parent / "cuobjdump"
    found = {}
    for stem in ("top2_batch", "top2_pair"):
        res = subprocess.run([str(tool), "-sass", str(kb.library_path(stem))],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            fail(f"cuobjdump -sass {stem}: rc={res.returncode} "
                 f"{res.stderr.strip()[:300]}")
        n, inside = 0, False
        for ln in res.stdout.splitlines():
            if "Function :" in ln:
                inside = "top2_l2_kernel" in ln
            elif inside and "HMMA" in ln:
                n += 1
        if n == 0:
            fail(f"{stem}: no HMMA instruction in top2_l2_kernel")
        found[stem] = n
    print(f"  sass: HMMA instructions in top2_l2_kernel {json.dumps(found)}",
          flush=True)
    return found


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call.  With inner = 1 the time includes the host's launch
    latency (the device waits for it); with more calls it hides behind the
    device's work where that is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------------ kernels

def make_case(rng, N, M, D, B, masked_frac=0.1, hamming=False,
              all_masked_lane=None):
    """numpy inputs (a [N,D], b [B,M,D], vb [B,M]): normal f32 values (or
    random bit words) with an exact duplicate column in lane 0 that query
    row 0 equals, ~masked_frac of columns masked, optionally a lane with
    every column masked."""
    import numpy as np

    if hamming:
        a = rng.integers(0, 2**32, (N, D), dtype=np.uint64).astype(
            np.uint32).view(np.int32)
        b = rng.integers(0, 2**32, (B, M, D), dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    else:
        a = rng.normal(size=(N, D)).astype(np.float32)
        b = rng.normal(size=(B, M, D)).astype(np.float32)
    # exact duplicates: ties resolve to the lowest column, d2 == d1
    b[0, M // 2] = b[0, 3]
    a[0] = b[0, 3]
    vb = rng.random((B, M)) >= masked_frac
    if all_masked_lane is not None:
        vb[all_masked_lane] = False
    return a, b, vb


def on_card(*xs):
    import torch

    return tuple(torch.from_numpy(x).to("cuda") for x in xs)


def host(res):
    import torch

    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in res]


def hold_exact(k, p, what):
    import numpy as np

    for x, y, nm in zip(k, p, ("d1", "idx1", "d2")):
        if not np.array_equal(x, y):
            fail(f"{what}: {nm} differs (must be exact)")


def hold_l2(k, p, a, b, what):
    """The L2 rule: idx1 equal wherever the plain version's top-2 gap
    exceeds 1e-3·max(1, d1), and where idx1 differs the two d1 agree within
    that gap; d1, d2 to rtol 1e-4 plus an absolute 1e-6·(|a|²+|b|²)max for
    the float32 cancellation in |a|²+|b|²−2a·b (the two sum the products in
    different orders).  Returns max |Δ| over real distances."""
    import numpy as np

    (kd1, ki1, kd2), (pd1, pi1, pd2) = k, p
    gap_tol = 1e-3 * np.maximum(1.0, pd1)
    clear = (pd2 - pd1) > gap_tol
    if not np.array_equal(ki1[clear], pi1[clear]):
        fail(f"{what}: idx1 differs on clear rows")
    diff = ki1 != pi1
    if np.any(np.abs(kd1[diff] - pd1[diff]) > gap_tol[diff]):
        fail(f"{what}: d1 differs beyond the gap where idx1 differs")
    nrm = float((a.astype(np.float32) ** 2).sum(-1).max()
                + (b.astype(np.float32) ** 2).sum(-1).max())
    for x, y, nm in ((kd1, pd1, "d1"), (kd2, pd2, "d2")):
        if not np.allclose(x, y, rtol=1e-4, atol=1e-6 * nrm):
            fail(f"{what}: {nm} differs: max |Δ| {np.abs(x - y).max()}")
    return max_err(k, p)


def hold_l1(k, p, what):
    """The L1 rule: idx1 equal wherever the plain version's top-2 gap
    exceeds 1e-5·max(1, d1); d1 and d2 to rtol 1e-5.  Returns max |Δ|."""
    import numpy as np

    (kd1, ki1, kd2), (pd1, pi1, pd2) = k, p
    clear = (pd2 - pd1) > 1e-5 * np.maximum(1.0, pd1)
    if not np.array_equal(ki1[clear], pi1[clear]):
        fail(f"{what}: idx1 differs on clear rows")
    for x, y, nm in ((kd1, pd1, "d1"), (kd2, pd2, "d2")):
        if not np.allclose(x, y, rtol=1e-5, atol=0.0):
            fail(f"{what}: {nm} differs: max |Δ| {np.abs(x - y).max()}")
    return max_err(k, p)


def max_err(k, p) -> float:
    import numpy as np

    (kd1, _, kd2), (pd1, _, pd2) = k, p
    return float(max(np.abs(kd1 - pd1)[pd1 < 1e38].max(initial=0.0),
                     np.abs(kd2 - pd2)[pd2 < 1e38].max(initial=0.0)))


def hold_edges(k, vb, what, all_masked_lane=None):
    """An all-masked lane gives d1 = d2 = 3e38, idx1 = 0; the duplicate
    column of make_case picks the lowest column with d2 == d1."""
    import numpy as np

    kd1, ki1, kd2 = (x if x.ndim == 2 else x[None] for x in k)
    if all_masked_lane is not None:
        lane = all_masked_lane
        if not (np.all(kd1[lane] == np.float32(BIG)) and
                np.all(ki1[lane] == 0) and np.all(kd2[lane] == np.float32(BIG))):
            fail(f"{what}: all-masked lane must give d1=d2=3e38, idx1=0")
    M = vb.shape[-1]
    if vb.reshape(-1, M)[0, 3] and vb.reshape(-1, M)[0, M // 2]:
        if ki1[0, 0] != 3 or kd2[0, 0] != kd1[0, 0]:
            fail(f"{what}: duplicate-column tie must pick the lowest column, "
                 "d2 == d1")


def library_top2(A, Bt, V, p):
    """The two-call yardstick: torch.cdist + torch.topk(2, smallest), with
    the column mask applied in between (a cheap masked_fill)."""
    import torch

    d = torch.cdist(A.expand(Bt.shape[0], -1, -1), Bt, p=p)
    d.masked_fill_(~V[:, None, :], BIG)
    return torch.topk(d, 2, dim=-1, largest=False)


def bound(flops, peak, nbytes):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def row(name, source, replaces, err, fn, plain_ms, bnd, two_call_ms):
    """A kernel's JSON row; ``fn`` calls its wrapper, timed once per event
    pair (``ms``, comparable with earlier PRs) and as 10 back-to-back calls
    (``back_to_back_ms``, closer to the device time of one launch)."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"slam_indoor_code_tpu_torch/csrc/{source}",
        "replaces": f"slam_indoor_code_tpu/ops/pallas_kernels.py:{replaces}",
        "launches": None,
        "max_abs_err": err,
        "ms": time_ms(fn),
        "back_to_back_ms": time_ms(fn, inner=10),
        "plain_ms": plain_ms,
        "bound_ms": bnd[0],
        "bound_by": bnd[1],
        # no single PyTorch call computes a masked top-2; library_top2 is
        # two (cdist, topk) with the mask applied between them
        "library_ms": None,
        "two_call_library_ms": two_call_ms,
    }


def kernels():
    """Every kernel against its plain version, timed at the main path's
    shapes.  Returns the JSON rows by key."""
    import numpy as np

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(0)
    N = M = 2048
    D, B = 128, 16
    rows = {}

    # top2_batch: main shapes, ragged with a masked lane, Hamming, D=384
    # (the hybrid descriptor, query tile resident) and D=700 (staged in
    # chunks); lanes_per_block 2 and 4 must equal lanes_per_block 1 exactly
    a, b, vb = make_case(rng, N, M, D, B)
    A, Bt, V = on_card(a, b, vb)
    k = host(ck.top2_batch(A, Bt, V))
    err = hold_l2(k, host(ck.top2_batch_plain(A, Bt, V)), a, b, "top2_batch")
    hold_edges(k, vb, "top2_batch")
    for lpb in (2, 4):
        hold_exact(host(ck.top2_batch(A, Bt, V, lanes_per_block=lpb)), k,
                   f"top2_batch lanes_per_block={lpb}")
    for n_, m_, d_, b_, lane in ((1999, 1500, D, 3, 1), (2048, 2048, 384, 4,
                                                         None),
                                 (300, 500, 700, 2, None), (1999, 1500, D, 6,
                                                            5)):
        a2, b2, vb2 = make_case(rng, n_, m_, d_, b_, all_masked_lane=lane)
        args = on_card(a2, b2, vb2)
        k2 = host(ck.top2_batch(*args))
        hold_l2(k2, host(ck.top2_batch_plain(*args)), a2, b2,
                f"top2_batch {n_}x{m_}x{d_} B={b_}")
        hold_edges(k2, vb2, f"top2_batch {n_}x{m_}x{d_}", lane)
        for lpb in (2, 4):
            hold_exact(host(ck.top2_batch(*args, lanes_per_block=lpb)), k2,
                       f"top2_batch lanes_per_block={lpb} B={b_}")
    ah, bh, vh = make_case(rng, 300, 257, 8, 4, hamming=True,
                           all_masked_lane=2)
    hargs = on_card(ah, bh, vh)
    kh = host(ck.top2_batch(*hargs, metric="hamming"))
    hold_exact(kh, host(ck.top2_batch_plain(*hargs, metric="hamming")),
               "top2_batch hamming")
    hold_exact(host(ck.top2_batch(*hargs, metric="hamming",
                                  lanes_per_block=4)), kh,
               "top2_batch hamming lanes_per_block=4")

    flops = 2.0 * B * N * M * D
    nbytes = 4 * N * D + 4 * B * M * D + B * M + 3 * 4 * B * N
    bnd = bound(flops, PEAK_BF16_FLOPS, nbytes)
    plain_ms = time_ms(lambda: ck.top2_batch_plain(A, Bt, V))
    lib_ms = time_ms(lambda: library_top2(A, Bt, V, 2.0))
    rows["top2_batch"] = row(
        "top2_batch", "top2_batch.cu", 225, err,
        lambda: ck.top2_batch(A, Bt, V), plain_ms, bnd, lib_ms)
    for lpb in (2, 4):
        rows[f"lpb{lpb}"] = row(
            f"top2_batch(lanes_per_block={lpb})", "top2_batch.cu", 253, 0.0,
            lambda: ck.top2_batch(A, Bt, V, lanes_per_block=lpb),
            plain_ms, bnd, lib_ms)

    # top2_batch with metric="hamming" at ORB's shapes: 2048 x 2048
    # descriptors of 8 words (256 bits, unpacked to 0/1 bf16 by the
    # wrapper), 16 candidate frames, one lane all masked; exact.  The
    # two-call yardstick is cdist(p=0) on the unpacked bits, then topk.
    ah, bh, vh = make_case(rng, N, M, 8, B, hamming=True, all_masked_lane=5)
    oargs = on_card(ah, bh, vh)
    ko = host(ck.top2_batch(*oargs, metric="hamming"))
    hold_exact(ko, host(ck.top2_batch_plain(*oargs, metric="hamming")),
               "top2_batch hamming at ORB's shapes")
    hold_edges(ko, vh, "top2_batch hamming at ORB's shapes", 5)
    bits_a = ck.unpack_bits(oargs[0]).float()
    bits_b = ck.unpack_bits(oargs[1]).float()
    rows["hamming"] = row(
        "top2_batch(metric=hamming)", "top2_batch.cu", 225, 0.0,
        lambda: ck.top2_batch(*oargs, metric="hamming"),
        time_ms(lambda: ck.top2_batch_plain(*oargs, metric="hamming")),
        bound(2.0 * B * N * M * 256, PEAK_BF16_FLOPS,
              4 * N * 8 + 4 * B * M * 8 + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(bits_a, bits_b, oargs[2], 0.0)))

    # top2_pair: L2 at 2048x2048x128 (lane 0 of the main case) and ragged;
    # Hamming at 300x257x8 words, exact
    pargs = (A, Bt[0].contiguous(), V[0].contiguous())
    kp = host(ck.top2_pair(*pargs))
    perr = hold_l2(kp, host(ck.top2_pair_plain(*pargs)), a, b[0], "top2_pair")
    hold_edges(kp, vb[0], "top2_pair")
    a2, b2, vb2 = make_case(rng, 1999, 1500, D, 1)
    args = on_card(a2, b2[0], vb2[0])
    hold_l2(host(ck.top2_pair(*args)), host(ck.top2_pair_plain(*args)), a2,
            b2[0], "top2_pair 1999x1500")
    hp = (hargs[0], hargs[1][0].contiguous(), hargs[2][0].contiguous())
    hold_exact(host(ck.top2_pair(*hp, metric="hamming")),
               host(ck.top2_pair_plain(*hp, metric="hamming")),
               "top2_pair hamming")
    rows["top2_pair"] = row(
        "top2_pair", "top2_pair.cu", 57, perr,
        lambda: ck.top2_pair(*pargs),
        time_ms(lambda: ck.top2_pair_plain(*pargs)),
        bound(2.0 * N * M * D, PEAK_BF16_FLOPS,
              4 * (N + M) * D + M + 3 * 4 * N),
        time_ms(lambda: library_top2(pargs[0], pargs[1][None],
                                     pargs[2][None], 2.0)))

    # top2_l1: main shapes (bit-exact in practice: both add |a-b| in order),
    # ragged with a masked lane at D=32
    k1 = host(ck.top2_l1(A, Bt, V))
    lerr = hold_l1(k1, host(ck.top2_l1_plain(A, Bt, V)), "top2_l1")
    hold_edges(k1, vb, "top2_l1")
    a2, b2, vb2 = make_case(rng, 1999, 1500, 32, 3, all_masked_lane=1)
    args = on_card(a2, b2, vb2)
    k2 = host(ck.top2_l1(*args))
    hold_l1(k2, host(ck.top2_l1_plain(*args)), "top2_l1 3x1999x1500x32")
    hold_edges(k2, vb2, "top2_l1 3x1999x1500x32", 1)
    terms = float(B) * N * M * D
    rows["top2_l1"] = row(
        "top2_l1", "top2_l1.cu", 86, lerr,
        lambda: ck.top2_l1(A, Bt, V),
        time_ms(lambda: ck.top2_l1_plain(A, Bt, V)),
        # subtract + add (|.| is an operand modifier) per term, each at half
        # the FMA-counted f32 peak
        bound(2.0 * terms, PEAK_FP32_FLOPS / 2.0,
              4 * N * D + 4 * B * M * D + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(A, Bt, V, 1.0)))

    # top2_batch at the hybrid descriptor's D=384 (pooled SIFT ⊕ α·bits):
    # FHD's 2048 keypoints and bench.py's 4K point's 10240, 16 candidate
    # frames; the plain version and the two-call yardstick run lane by lane
    # (at 4K a [16,10240,10240] f32 distance block is 6.7 GB)
    for key, n_ in (("d384", N), ("d384_4k", 10240)):
        a3, b3, vb3 = make_case(rng, n_, n_, 384, B)
        args3 = on_card(a3, b3, vb3)
        k3 = host(ck.top2_batch(*args3))
        err3 = hold_l2(k3, host(plain_by_lane(*args3)), a3, b3,
                       f"top2_batch {n_}x{n_}x384 B={B}")
        hold_edges(k3, vb3, f"top2_batch {n_}x{n_}x384")
        rows[key] = row(
            f"top2_batch(D=384, N=M={n_})", "top2_batch.cu", 225, err3,
            lambda: ck.top2_batch(*args3),
            time_ms(lambda: plain_by_lane(*args3)),
            bound(2.0 * B * n_ * n_ * 384, PEAK_BF16_FLOPS,
                  4 * n_ * 384 + 4 * B * n_ * 384 + B * n_ + 3 * 4 * B * n_),
            time_ms(lambda: library_by_lane(*args3, 2.0)))
        del a3, b3, args3
    return rows


def library_by_lane(A, Bt, V, p):
    """``library_top2`` one candidate lane at a time (see plain_by_lane)."""
    return [library_top2(A, Bt[i:i + 1], V[i:i + 1], p)
            for i in range(Bt.shape[0])]


def host_words_row(engine):
    """``top2_batch`` with metric "hamming" on the host's ORB words as the
    hostorb path left them in its ring (ring_operands), held exactly to its
    plain version, as a kernel row."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    A, Bt, V = ring_operands(engine)
    k = host(ck.top2_batch(A, Bt, V, metric="hamming"))
    hold_exact(k, host(ck.top2_batch_plain(A, Bt, V, metric="hamming")),
               "top2_batch hamming on host ORB words")
    N, (B, M) = A.shape[0], V.shape
    bits_a, bits_b = ck.unpack_bits(A).float(), ck.unpack_bits(Bt).float()
    return row(
        "top2_batch(metric=hamming, host ORB words)", "top2_batch.cu", 225,
        0.0, lambda: ck.top2_batch(A, Bt, V, metric="hamming"),
        time_ms(lambda: ck.top2_batch_plain(A, Bt, V, metric="hamming")),
        bound(2.0 * B * N * M * 256, PEAK_BF16_FLOPS,
              4 * N * 8 + 4 * B * M * 8 + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(bits_a, bits_b, V, 0.0)))


# ------------------------------------------------------------- main paths

def rel_ate_pct(scene, rotations, positions, frame_ids) -> float:
    """ATE against ground truth (Sim(3)-aligned, paired by source frame
    id) as % of the trajectory extent."""
    import numpy as np

    from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
    from slam_indoor_code_tpu_torch.metrics.ate import camera_centers

    est = camera_centers(rotations, positions)
    gt = scene.centers()[np.asarray(frame_ids, np.int64)]
    return 100 * absolute_trajectory_error(est, gt) / float(
        np.linalg.norm(gt.max(0) - gt.min(0)))


def trajectory_ok(what, scene, gd, n_frames: int = N_FRAMES,
                  min_cameras: int = MIN_CAMERAS):
    """Cameras, finite poses and points, ATE against ground truth."""
    import numpy as np

    n_cams = len(gd.rotations)
    if n_cams < min_cameras:
        fail(f"{what}: only {n_cams}/{n_frames} frames became cameras")
    if not all(np.all(np.isfinite(x)) for x in (gd.rotations, gd.positions,
                                                 gd.points)):
        fail(f"{what}: non-finite poses or map points")
    ate_pct = rel_ate_pct(scene, gd.rotations, gd.positions, gd.frame_ids)
    if not ate_pct < 100 * ATE_MAX_FRAC:
        fail(f"{what}: ATE {ate_pct:.4f}% >= {100 * ATE_MAX_FRAC}% of extent")
    return n_cams, ate_pct


def on_cuda(what, engine):
    for name, t in engine.state.tensors().items():
        if t.device.type != "cuda":
            fail(f"{what}: TrackerState.{name} is on {t.device}")


PLAIN = ("top2_batch_plain", "top2_pair_plain", "top2_l1_plain")
PLAIN_CALLS = {"n": 0}


def count_plain_calls() -> None:
    """Wrap each kernel's plain version so that a call counts in
    PLAIN_CALLS: a path on the card must never reach one.  The kernel
    phase's comparisons call them directly and are not counted (they run
    before this is installed)."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    for name in PLAIN:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, **kw):
            PLAIN_CALLS["n"] += 1
            return _fn(*a, **kw)

        setattr(ck, name, counted)


def reset_counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    for fn in (ck.top2_batch, ck.top2_pair, ck.top2_l1):
        fn.launches = 0
    ck.top2_batch.multi_lane_launches = 0
    ck.top2_batch.hamming_launches = 0
    PLAIN_CALLS["n"] = 0


def counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    return {"top2_batch": ck.top2_batch.launches,
            "lpb": ck.top2_batch.multi_lane_launches,
            "hamming": ck.top2_batch.hamming_launches,
            "top2_pair": ck.top2_pair.launches,
            "top2_l1": ck.top2_l1.launches,
            "plain": PLAIN_CALLS["n"]}


def slam_run(cfg, scene, frames):
    """``slam_main(cfg)`` on CUDA, launch counts set to 0 just before and
    read just after → (counts, GlobalData, wall seconds, the runtime (the
    DeviceEngine, or the classic conductor's MainCycle), what the run
    logged: {"poses": the text of poses.txt, "picks": the chosen batch
    index of each scan step in time.txt}."""
    import torch

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.pipeline import MainCycle
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine

    runtimes = []
    origs = {cls: cls.__init__ for cls in (DeviceEngine, MainCycle)}

    def spying(orig_init):
        def spy_init(self, *a, **kw):   # keep a handle on the runtime
            orig_init(self, *a, **kw)
            runtimes.append(self)
        return spy_init

    for cls, orig in origs.items():
        cls.__init__ = spying(orig)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        gd = slam_main(cfg, scene.K, frames=frames, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = counts()
    finally:
        for cls, orig in origs.items():
            cls.__init__ = orig
    with open(f"{cfg.outputDataDir}/poses.txt") as f:
        poses_text = f.read()
    with open(f"{cfg.outputDataDir}/time.txt") as f:
        picks = [int(ln.split()[4]) for ln in f
                 if ln.startswith("Matching time for index")]
    if n["plain"]:
        fail(f"a kernel's plain version was called {n['plain']} times on "
             "the card")
    return n, gd, wall, runtimes[0], {"poses": poses_text, "picks": picks}


def report(what, n_cams, ate_pct, gd, wall, n, card_line,
           n_frames: int = N_FRAMES):
    print(f"{what}: cameras {n_cams}/{n_frames}  ATE {ate_pct:.4f}%"
          f" of extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{n_frames / wall:.3f} frames/s  launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)


def main_path(card_line: str, scene, frames, what: str = "main path"):
    """``slam_main`` on CUDA with the headline configuration → (launch
    counts of the run, its GlobalData, what it logged: see slam_run)."""
    with tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, logged = slam_run(headline_config(out), scene,
                                               frames)
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    n_logged = logged["poses"].count("\n")
    if n_logged < n_cams:
        fail(f"poses.txt has {n_logged} rows for {n_cams} cameras")
    on_cuda(what, engine)
    # one launch per tracked frame; the bootstrap pair shares one
    if n["top2_batch"] < n_cams - 1:
        fail(f"top2_batch launched {n['top2_batch']} times for {n_cams} "
             "cameras")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    return n, gd, logged


def orb_path(card_line: str, scene, frames, what: str = "orb path"):
    """``slam_main`` with only ``useFM-ORB`` set → (launch counts,
    GlobalData): every scan step through the Hamming ``top2_batch``."""
    import torch

    with tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(orb_config(out), scene, frames)
    if (engine.cfg.descriptor, engine.cfg.metric) != ("orb", "hamming"):
        fail(f"{what}: the engine took {engine.cfg.descriptor}/"
             f"{engine.cfg.metric}, not orb/hamming")
    if engine.state.ring_desc.dtype != torch.int32 or tuple(
            engine.state.ring_desc.shape[-1:]) != (8,):
        fail(f"{what}: descriptors {engine.state.ring_desc.dtype} "
             f"{tuple(engine.state.ring_desc.shape)}, not int32 [..,8]")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["hamming"] < n_cams - 1:
        fail(f"{what}: the Hamming top2_batch launched {n['hamming']} times "
             f"for {n_cams} cameras")
    if n["top2_batch"] != n["hamming"] or n["top2_l1"] or n["top2_pair"]:
        fail(f"{what}: launched another kernel than the Hamming top2_batch: "
             f"{n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    return n, gd


def global_path(card_line: str, scene, frames, gd_main):
    """The headline with ``tpu.global_ba`` → (launch counts, the solve's
    numbers).  The windowed trajectory handed to the refinement is phase
    4's (collecting the observations changes nothing), which is checked."""
    import math

    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch import app
    from slam_indoor_code_tpu_torch.solver import global_ba

    rec = {}
    orig_refine = app._global_refine
    orig_solve = global_ba.global_bundle_adjust

    def spy_refine(engine, gd, logs, cfg):
        rec["before"] = rel_ate_pct(scene, gd.rotations, gd.positions,
                                    gd.frame_ids)
        rec["same_windowed"] = (
            np.array_equal(gd.rotations, gd_main.rotations)
            and np.array_equal(gd.positions, gd_main.positions))
        out = orig_refine(engine, gd, logs, cfg)
        rec["accepted"] = out is not None
        return out

    def spy_solve(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig_solve(*a, **kw)
        torch.cuda.synchronize()
        rec["solve_s"] = time.perf_counter() - t
        rec["info"] = {k: float(v) for k, v in res[2].items()}
        rec["obs"] = int(a[4].shape[0])
        rec["cams"] = int(a[2].shape[0])
        return res

    app._global_refine, global_ba.global_bundle_adjust = spy_refine, spy_solve
    try:
        with tempfile.TemporaryDirectory() as out:
            cfg = headline_config(out)
            cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
                cfg.tpu, global_ba=True))
            n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
            with open(f"{out}/main.txt") as f:
                logged = "Global Bundle Adjustment statistics" in f.read()
    finally:
        app._global_refine, global_ba.global_bundle_adjust = (orig_refine,
                                                              orig_solve)
    if "info" not in rec or not logged:
        fail("global: the final global BA did not run")
    info = rec["info"]
    if not math.isfinite(info["final_rmse"]):
        fail(f"global: final RMSE {info['final_rmse']}")
    n_cams, ate_pct = trajectory_ok("global", scene, gd)
    on_cuda("global", engine)
    print(f"global: cameras {n_cams}/{N_FRAMES}  RMSE "
          f"{info['initial_rmse']:.6f} -> {info['final_rmse']:.6f} px over {int(info['num_residuals'])}"
          f" residuals ({rec['obs']} padded, {rec['cams']} camera slots), "
          f"{info['num_iters']:.0f} LM iterations, "
          f"{'accepted' if rec['accepted'] else 'rejected'}  solve "
          f"{rec['solve_s']:.3f} s  ATE {rec['before']:.4f}% -> "
          f"{ate_pct:.4f}% of extent  windowed trajectory equals the main "
          f"path's: {rec['same_windowed']}  wall {wall:.3f} s  "
          f"[{card_line}]", flush=True)
    return n, rec


def resume_path(card_line: str, scene, frames, gd_main):
    """The headline with ``tpu.checkpoint_path`` and ``checkpoint_every``
    = 16 crashes in the first window after its first snapshot; a second
    ``slam_main`` with ``tpu.resume_path`` continues it and must equal phase
    4's run bit for bit.  At 32 frames the engine has read every frame of
    its media before its first snapshot (ingest prefetches up to ~48), so
    the crash is raised in the next ``advance_window`` instead of by the
    media.  → launch counts of the resumed run."""
    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.runtime import checkpoint_next_fid, steps

    with tempfile.TemporaryDirectory() as out:
        ck = os.path.join(out, "run.npz")
        cfg = headline_config(os.path.join(out, "killed"))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, checkpoint_path=ck, checkpoint_every=16))
        orig = steps.advance_window

        def crashing(*a, **kw):
            if os.path.exists(ck):
                raise RuntimeError("simulated crash")
            return orig(*a, **kw)

        steps.advance_window = crashing
        try:
            slam_main(cfg, scene.K, frames=frames, seed=0)
            fail("resume: the run did not crash after a snapshot")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        finally:
            steps.advance_window = orig
        next_fid = checkpoint_next_fid(ck)
        size_mb = os.path.getsize(ck) / 1e6
        cfg = headline_config(os.path.join(out, "resumed"))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, resume_path=ck))
        n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
        with open(os.path.join(out, "resumed", "main.txt")) as f:
            if "Resumed from" not in f.read():
                fail("resume: main.txt has no 'Resumed from' line")
    on_cuda("resume", engine)
    same_run("resume (resumed vs uninterrupted)", gd_main, gd)
    print(f"resume: crashed after a snapshot at source frame {next_fid - 1} "
          f"({size_mb:.1f} MB npz); the resumed run ({wall:.3f} s, launches "
          f"{json.dumps(n)}) equals the uninterrupted one  [{card_line}]",
          flush=True)
    return n


@contextlib.contextmanager
def timed_host_ingest():
    """Time every ``host_detect_pack`` call (the host ingest, run in the
    engine's packer threads) while the block runs, and inside it the gray
    conversion, FAST, the ORB bits and the pooling → {"s": seconds summed
    over the calls, "frames": frames packed, "parts": {part: seconds},
    "gray_planes": chunks that returned a gray plane}."""
    import threading

    from slam_indoor_code_tpu_torch.models import frontend

    spent = {"s": 0.0, "frames": 0, "gray_planes": 0,
             "parts": {"gray": 0.0, "fast": 0.0, "orb": 0.0, "pool": 0.0}}
    lock = threading.Lock()
    names = {"gray": "host_gray", "fast": "_host_detect_frame",
             "orb": "host_orb_bits", "pool": "area_downscale"}
    origs = {attr: getattr(frontend, attr)
             for attr in ("host_detect_pack", *names.values())}

    def timed(chunk, *a, **kw):
        t = time.perf_counter()
        out = origs["host_detect_pack"](chunk, *a, **kw)
        with lock:
            spent["s"] += time.perf_counter() - t
            spent["frames"] += len(chunk)
            spent["gray_planes"] += "gray_small" in out
        return out

    def timed_part(part, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            with lock:
                spent["parts"][part] += time.perf_counter() - t
            return out
        return run

    frontend.host_detect_pack = timed
    for part, attr in names.items():
        setattr(frontend, attr, timed_part(part, origs[attr]))
    try:
        yield spent
    finally:
        for attr, fn in origs.items():
            setattr(frontend, attr, fn)


@contextlib.contextmanager
def timed_tracking():
    """Time every ``steps.advance_stream`` call on the main thread (the
    streaming loop's scan steps and in-scan BA; its host reads make the
    call wait for the card) → {"s": seconds, "calls": calls}."""
    from slam_indoor_code_tpu_torch.runtime import steps

    spent = {"s": 0.0, "calls": 0}
    orig = steps.advance_stream

    def timed(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        spent["s"] += time.perf_counter() - t
        spent["calls"] += 1
        return out

    steps.advance_stream = timed
    try:
        yield spent
    finally:
        steps.advance_stream = orig


def ingest_line(spent, n_frames: int) -> str:
    """Host ingest ms per frame and its parts, from timed_host_ingest."""
    f = max(spent["frames"], 1)
    parts = ", ".join(f"{k} {1e3 * v / f:.3f}"
                      for k, v in spent["parts"].items())
    return (f"host ingest {1e3 * spent['s'] / f:.3f} ms per frame ({parts}; "
            f"{spent['frames']} frames packed for {n_frames} on "
            f"{os.cpu_count()} cores)")


def stream_path(card_line: str, scene, frames, what: str = "stream path"):
    """``slam_main`` with ``stream_config`` → (launch counts, GlobalData):
    every active scan step and each bootstrap ``match_select`` through
    ``top2_batch``, nothing else; the host ingest timed per frame."""
    with timed_host_ingest() as spent, \
            tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(stream_config(out), scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "same" and cfg.ingest_downscale == 2):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, "
             f"host_desc {cfg.host_desc}, d={cfg.ingest_downscale}, "
             f"streaming {engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}, "
          f"{engine.stream_calls} advance_stream calls, "
          f"{engine.stream_steps} active scan steps, "
          f"{engine.match_select_calls} bootstrap match_select  "
          f"[{card_line}]", flush=True)
    return n, gd


def plain_by_lane(A, Bt, V, metric: str = "l2"):
    """``top2_batch_plain`` one candidate lane at a time, concatenated: the
    plain version holds [1,N,M] f32 distances at once instead of [B,N,M]
    (6.7 GB at the 4K shape)."""
    import torch

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    outs = [ck.top2_batch_plain(A, Bt[i:i + 1], V[i:i + 1], metric)
            for i in range(Bt.shape[0])]
    return tuple(torch.cat(x) for x in zip(*outs))


def ring_operands(engine, lanes: int = 16):
    """The ring of a finished run as the path hands it to ``top2_batch``:
    the slot of the earliest frame still held as the query, the next
    ``lanes`` frames' slots as the candidates, their validity as the column
    mask → (A [K,D], Bt [lanes,K,D], V [lanes,K]) on the card."""
    import torch

    by_frame = sorted(engine._slot_frame.items(), key=lambda kv: kv[1])
    idx = torch.tensor([slot for slot, _ in by_frame[:lanes + 1]],
                       device=engine.state.ring_desc.device)
    st = engine.state
    return (st.ring_desc[idx[0]].contiguous(),
            st.ring_desc[idx[1:]].contiguous(),
            st.ring_valid[idx[1:]].contiguous())


def hold_on_ring(engine, metric: str, what: str) -> float:
    """``top2_batch`` on the ring's own descriptors (ring_operands) against
    its plain version, lane by lane: Hamming exact, L2 by ``hold_l2``.
    Returns max |Δ|."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    A, Bt, V = ring_operands(engine)
    k = host(ck.top2_batch(A, Bt, V, metric=metric))
    p = host(plain_by_lane(A, Bt, V, metric))
    if metric == "hamming":
        hold_exact(k, p, what)
        return 0.0
    return hold_l2(k, p, host((A,))[0], host((Bt,))[0], what)


@contextlib.contextmanager
def host_desc_calls():
    """Count the calls of the three host-ingest steps while the block runs
    → {"same": n, "hybrid": n, "orb": n, "ring": ...}; the first
    ``ingest_host_hybrid`` call also records one ring slot it wrote in
    "ring": {"slot", "equal" (its last 256 columns equal α × the uploaded
    bits, MSB first), "rows" (rows with a bit set), "sift_rows" (rows with
    a SIFT value)}."""
    import numpy as np

    from slam_indoor_code_tpu_torch.runtime import steps

    calls = {"same": 0, "hybrid": 0, "orb": 0, "ring": {}}
    names = {"same": "ingest_host", "hybrid": "ingest_host_hybrid",
             "orb": "ingest_host_desc"}
    origs = {k: getattr(steps, v) for k, v in names.items()}

    def counted(kind):
        def run(cfg, state, *a, **kw):
            state = origs[kind](cfg, state, *a, **kw)
            calls[kind] += 1
            if kind == "hybrid" and not calls["ring"]:
                desc_bits, slots = a[1], a[5]
                slot = int(slots[0])
                bits = np.unpackbits(desc_bits[0].cpu().numpy(), axis=-1,
                                     bitorder="big")
                got = state.ring_desc[slot].cpu().numpy()
                calls["ring"] = {
                    "slot": slot,
                    "equal": bool(np.array_equal(
                        got[:, 128:], np.float32(cfg.hybrid_alpha) * bits)),
                    "rows": int(bits.any(-1).sum()),
                    "sift_rows": int((got[:, :128] != 0).any(-1).sum())}
            return state
        return run

    for kind, name in names.items():
        setattr(steps, name, counted(kind))
    try:
        yield calls
    finally:
        for kind, name in names.items():
            setattr(steps, name, origs[kind])


def host_desc_run(cfg_fn, scene, frames):
    """``slam_run`` of ``cfg_fn`` with the host ingest, its parts, the
    tracking calls, the host-ingest steps and the peak device memory
    recorded → (counts, GlobalData, wall, engine, ingest, tracking, step
    calls, peak bytes)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    with host_desc_calls() as calls, timed_host_ingest() as spent, \
            timed_tracking() as trk, tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(cfg_fn(out), scene, frames)
    peak = torch.cuda.max_memory_allocated()
    return n, gd, wall, engine, spent, trk, calls, peak


def hold_stream_launches(what, n, engine, metric: str):
    """One ``top2_batch`` launch per active scan step and per bootstrap
    ``match_select``, all with ``metric``, and no other kernel."""
    want = engine.stream_steps + engine.match_select_calls
    if n["top2_batch"] != want or engine.stream_steps == 0:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{engine.stream_steps} active scan steps and "
             f"{engine.match_select_calls} bootstrap matches")
    n_metric = n["top2_batch"] if metric == "l2" else n["hamming"]
    if (n_metric != n["top2_batch"] or n["top2_l1"] or n["top2_pair"]
            or (metric == "l2" and n["hamming"])):
        fail(f"{what}: launched another kernel than the {metric} "
             f"top2_batch: {n}")


def hybrid_path(card_line: str, scene, frames, what: str = "hybrid path"):
    """``slam_main`` with ``hybrid_config`` (host descriptor "auto" under
    host ingest) → (launch counts, GlobalData, engine): it must resolve to
    "hybrid" with 384-dim descriptors, track as the other paths do, launch
    the L2 ``top2_batch`` once per active scan step and bootstrap match, and
    write α × the host's bits into the last 256 columns of a ring slot."""
    n, gd, wall, engine, spent, trk, calls, _ = host_desc_run(
        hybrid_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "hybrid" and cfg.desc_dim == 384
            and cfg.metric == "l2" and cfg.ingest_downscale == 2
            and tuple(engine.state.ring_desc.shape[-1:]) == (384,)):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, host_desc "
             f"{cfg.host_desc}, D={cfg.desc_dim}, metric {cfg.metric}, "
             f"d={cfg.ingest_downscale}, streaming {engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    ring = calls["ring"]
    if calls["same"] or calls["orb"] or not calls["hybrid"]:
        fail(f"{what}: host-ingest steps {calls}")
    if not (ring.get("equal") and ring["rows"] > 100
            and ring["sift_rows"] > 100):
        fail(f"{what}: ring slot {ring}: the last 256 columns are not "
             "α × the host's bits")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; ring slot {ring['slot']}: "
          f"columns 128..383 equal {cfg.hybrid_alpha} x the uploaded bits on"
          f" {ring['rows']} rows  [{card_line}]", flush=True)
    return n, gd, engine


def hostorb_path(card_line: str, scene, frames, what: str = "hostorb path"):
    """``slam_main`` with ``hostorb_config`` (ORB, host descriptor "auto"
    under host ingest) → (launch counts, GlobalData, engine): it must
    resolve to "orb", upload no gray plane (no chunk packs one, only
    ``ingest_host_desc`` runs), track as the other paths do and launch the
    Hamming ``top2_batch`` once per active scan step and bootstrap
    match."""
    import torch

    n, gd, wall, engine, spent, trk, calls, _ = host_desc_run(
        hostorb_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "orb" and cfg.metric == "hamming"):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, host_desc "
             f"{cfg.host_desc}, metric {cfg.metric}, streaming "
             f"{engine._will_stream}")
    if engine.state.ring_desc.dtype != torch.int32 or tuple(
            engine.state.ring_desc.shape[-1:]) != (8,):
        fail(f"{what}: descriptors {engine.state.ring_desc.dtype} "
             f"{tuple(engine.state.ring_desc.shape)}, not int32 [..,8]")
    if spent["gray_planes"] or calls["same"] or calls["hybrid"] or \
            not calls["orb"]:
        fail(f"{what}: a gray plane was packed or described: "
             f"{spent['gray_planes']} chunks with a gray plane, steps "
             f"{calls}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "hamming")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; no gray plane packed or "
          f"uploaded, {calls['orb']} ingest_host_desc calls  "
          f"[{card_line}]", flush=True)
    return n, gd, engine


def fourk_path(card_line: str, scene, frames, kernel_ms: float,
               bound_ms: float):
    """``slam_main`` with ``fourk_config`` on the 4K scene → (launch
    counts, GlobalData, engine): hybrid descriptors at 10,240 keypoints,
    at least 12/16 cameras at ATE < 5 %; prints the host ingest per frame
    and its parts beside the tracking per frame, the ring's size and the
    peak device memory, and the kernel's time per call at this shape."""
    what = "4k path"
    n, gd, wall, engine, spent, trk, calls, peak = host_desc_run(
        fourk_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.host_desc == "hybrid"
            and cfg.desc_dim == 384 and cfg.ingest_downscale == 4
            and cfg.max_keypoints == 10240 and cfg.hybrid_alpha == 0.15):
        fail(f"{what}: the engine took host_desc {cfg.host_desc}, D="
             f"{cfg.desc_dim}, d={cfg.ingest_downscale}, K="
             f"{cfg.max_keypoints}, α={cfg.hybrid_alpha}, streaming "
             f"{engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd, N_FRAMES_4K,
                                    MIN_CAMERAS_4K)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    if not calls["ring"].get("equal"):
        fail(f"{what}: ring slot {calls['ring']}: the last 256 columns are "
             "not α × the host's bits")
    ring_mb = engine.state.ring_desc.numel() * 4 / 1e6
    report(what, n_cams, ate_pct, gd, wall, n, card_line, N_FRAMES_4K)
    print(f"{what}: {ingest_line(spent, N_FRAMES_4K)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES_4K:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; top2_batch "
          f"{kernel_ms:.4f} ms per call at [10240,384] x [16,10240,384] "
          f"(bound {bound_ms:.4f} ms); ring {tuple(engine.state.ring_desc.shape)}"
          f" {ring_mb:.1f} MB; peak device memory {peak / 1e9:.3f} GB  "
          f"[{card_line}]", flush=True)
    return n, gd, engine


def run_engine(scene, frames, metric: str):
    """``DeviceEngine.run`` on CUDA with the headline configuration and
    ``EngineConfig.metric`` set, restarted on track loss as slam_main does
    → (GlobalData with the map, engine)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io.logs import GlobalData
    from slam_indoor_code_tpu_torch.io.media import ArraySource
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig

    cfg = headline_config("unused")
    ecfg = dataclasses.replace(EngineConfig.from_config(cfg), metric=metric)
    engine = DeviceEngine(ArraySource(frames), scene.K, ecfg,
                          batch_size=cfg.framesBatchSize,
                          required_extracted=cfg.requiredExtractedPointsCount,
                          seed=0, device="cuda")
    gd = GlobalData()
    init_R, init_t = np.eye(3), np.zeros(3)
    while True:
        res = engine.run(init_R, init_t)
        gd.extend(res["global_data"])
        if res["status"] != "interrupted" or res["last_pose"] is None:
            break
        init_R, init_t = res["last_pose"]
        if engine.media_exhausted:
            break
    gd.points, _ = engine.snapshot_map()
    return gd, engine


def l1_path(card_line: str, scene, frames, what: str = "l1 path"):
    """The L1 matching path: run_engine with metric="l1" → (launch counts,
    GlobalData)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    gd, engine = run_engine(scene, frames, "l1")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = counts()
    if engine.cfg.metric != "l1":
        fail("the engine did not take metric='l1'")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["top2_l1"] < n_cams - 1:
        fail(f"top2_l1 launched {n['top2_l1']} times for {n_cams} cameras")
    if n["top2_batch"] != 0:
        fail(f"the L1 path launched top2_batch {n['top2_batch']} times")
    print(f"{what}: cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{N_FRAMES / wall:.3f} frames/s  launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)
    return n, gd


def same_run(what: str, first, second, tag: str = "repro") -> None:
    """Two runs of one path on the same frames and seed must agree bit for
    bit: the same cameras (source frame ids), map size, poses and map
    points."""
    import numpy as np

    fields = {"cameras": (np.asarray(first.frame_ids),
                          np.asarray(second.frame_ids)),
              "map size": (len(first.points), len(second.points)),
              "rotations": (first.rotations, second.rotations),
              "positions": (first.positions, second.positions),
              "map points": (first.points, second.points)}
    for name, (x, y) in fields.items():
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail(f"{what}: {name} differ between two runs")
    print(f"{tag} {what}: the two runs equal bit for bit: cameras "
          f"{len(first.rotations)}, map {len(first.points)} points",
          flush=True)


def pair_entry(card_line: str, frames):
    """knn.match_pair on CUDA with 2048-keypoint SIFT descriptors of frames
    0 and 2 against match_pair on CPU copies of the same tensors.  The
    kernel rounds its operands to bf16 (as the TPU kernel does) where the
    CPU path keeps f32, so rows may differ where the bf16-rounded plain
    version decides the ratio test otherwise than the f32 one, or where its
    ratio margin d1 − r²·d2 is inside the L2 rule's distance tolerance
    (rtol 1e-4 plus 1e-6·(|a|²+|b|²) on each of d1 and d2); nowhere
    else."""
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.models.frontend import (
        FrontendConfig, extract_and_describe_gray_batch, pack_frames)
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck
    from slam_indoor_code_tpu_torch.ops import knn

    ratio = 0.8
    gray, small = pack_frames([frames[0], frames[2]])
    det = extract_and_describe_gray_batch(
        FrontendConfig(max_keypoints=2048, threshold=20.0, ratio=ratio),
        torch.from_numpy(gray).cuda(), torch.from_numpy(small).cuda())
    desc, valid = det["desc"], det["valid"]
    if tuple(desc.shape) != (2, 2048, 128):
        fail(f"pair: descriptors {tuple(desc.shape)}")
    torch.cuda.synchronize()
    reset_counts()
    got = knn.match_pair(desc[0], valid[0], desc[1], valid[1], ratio, "l2")
    torch.cuda.synchronize()
    n = counts()
    if n["top2_pair"] != 1 or sum(n.values()) != 1:
        fail(f"pair: match_pair launched {n}")
    dc, vc = desc.cpu(), valid.cpu()
    ref = knn.match_pair(dc[0], vc[0], dc[1], vc[1], ratio, "l2")
    pd1, _, pd2 = (x.numpy() for x in ck.top2_pair_plain(dc[0], dc[1], vc[1]))
    r2 = np.float32(ratio) * np.float32(ratio)
    atol = 1e-6 * float((dc.float() ** 2).sum(-1).max()) * 2.0
    margin_tol = (1e-4 * pd1 + atol) + r2 * (1e-4 * np.minimum(pd2, 1e30)
                                             + atol)
    plain_match = (pd1 < r2 * pd2) & vc[0].numpy() & (pd1 < BIG / 2)
    ref_match = ref["is_match"].numpy()
    open_rows = (np.abs(pd1 - r2 * pd2) <= margin_tol) | (
        plain_match != ref_match)
    got_match = got["is_match"].cpu().numpy()
    if np.any(got_match[~open_rows] != ref_match[~open_rows]):
        fail("pair: is_match differs outside the open rows")
    both = got_match & ref_match
    if np.any(got["train_idx"].cpu().numpy()[both]
              != ref["train_idx"].numpy()[both]):
        fail("pair: train_idx differs on rows both sides match")
    n_got, n_ref = int(got["num_matches"]), int(ref["num_matches"])
    if abs(n_got - n_ref) > int(open_rows.sum()) or n_ref < 100:
        fail(f"pair: num_matches {n_got} vs CPU {n_ref} "
             f"({int(open_rows.sum())} open rows)")
    print(f"pair entry: num_matches {n_got} on the card, {n_ref} on the CPU "
          f"copies, {int(open_rows.sum())} open rows, launches "
          f"{json.dumps(n)}  [{card_line}]", flush=True)
    return n


def classic_config(out_dir: str):
    """The headline configuration on the classic host conductor
    (``tpu.device_runtime=false``)."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, device_runtime=False))


def classic_path(card_line: str, scene, frames, what: str = "classic path"):
    """``slam_main`` with ``classic_config`` → (launch counts, GlobalData):
    one ``top2_batch`` launch per ``find_good_frame`` scan that matched,
    the descriptors on the card, no other kernel."""
    from slam_indoor_code_tpu_torch.models import frontend
    from slam_indoor_code_tpu_torch.pipeline import MainCycle

    devices = set()
    orig = frontend.match_against_batch

    def spy(fcfg, desc_prev, valid_prev, desc_batch, *a, **kw):
        devices.add((desc_prev.device.type, desc_batch.device.type))
        return orig(fcfg, desc_prev, valid_prev, desc_batch, *a, **kw)

    frontend.match_against_batch = spy
    try:
        with tempfile.TemporaryDirectory() as out:
            n, gd, wall, cycle, _ = slam_run(classic_config(out), scene,
                                             frames)
    finally:
        frontend.match_against_batch = orig
    if not isinstance(cycle, MainCycle):
        fail(f"{what}: slam_main did not take the classic conductor")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    if devices != {("cuda", "cuda")}:
        fail(f"{what}: descriptors matched on {sorted(devices)}")
    scans = cycle.scheduler.scans
    if n["top2_batch"] != scans or scans == 0:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{scans} matched find_good_frame scans")
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {scans} find_good_frame scans, one top2_batch launch "
          f"each  [{card_line}]", flush=True)
    return n, gd


def first_divergence(a, b):
    """The first camera at which two runs part (a different source frame or
    pose, bit for bit), None where they are equal throughout."""
    import numpy as np

    n = min(len(a.rotations), len(b.rotations))
    for i in range(n):
        if (a.frame_ids[i] != b.frame_ids[i]
                or not np.array_equal(a.rotations[i], b.rotations[i])
                or not np.array_equal(a.positions[i], b.positions[i])):
            return i
    if len(a.rotations) != len(b.rotations):
        return n
    return None


def telemetry_path(card_line: str, scene, frames, gd_l2, logged_l2):
    """The headline with ``per_frame_telemetry``: the device runtime's
    classic loop one step per call, one "Matching time for index" line per
    scan step in time.txt, one ``top2_batch`` launch per scan step (and per
    bootstrap ``match_select``).  Prints whether it equals the fused L2
    run bit for bit and, if not, where the two part → launch counts."""
    import numpy as np

    with tempfile.TemporaryDirectory() as out:
        cfg = headline_config(out)
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, per_frame_telemetry=True))
        n, gd, wall, engine, logged = slam_run(cfg, scene, frames)
    picks, picks_l2 = logged["picks"], logged_l2["picks"]
    what = "telemetry"
    if engine._will_stream or not engine.cfg.per_frame_telemetry:
        fail(f"{what}: the engine did not take the one-step classic loop")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if len(picks) < n_cams - 2:
        fail(f"{what}: {len(picks)} 'Matching time for index' lines for "
             f"{n_cams} cameras")
    if n["top2_batch"] != len(picks) + engine.match_select_calls:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{len(picks)} scan steps and {engine.match_select_calls} "
             "bootstrap matches")
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    part = first_divergence(gd_l2, gd)
    same_map = (len(gd.points) == len(gd_l2.points)
                and np.array_equal(gd.points, gd_l2.points))
    step = next((i for i, (x, y) in enumerate(zip(picks_l2, picks))
                 if x != y), None)
    if step is None and len(picks) != len(picks_l2):
        step = min(len(picks), len(picks_l2))
    print(f"{what}: {len(picks)} per-step time.txt lines; equals the fused "
          f"L2 run bit for bit: cameras and poses "
          f"{part is None}, map {same_map}; first camera that differs: "
          f"{part}; first scan step whose chosen index differs: {step} "
          f"(fused {picks_l2[step:step + 3] if step is not None else '-'}, "
          f"per-frame {picks[step:step + 3] if step is not None else '-'})"
          f"  [{card_line}]", flush=True)
    return n


def cli_path(card_line: str, scene, frames, logged_l2):
    """The reference binary's contract: the 32 frames as PNG files, K as
    OpenCV XML, the headline configuration as JSON (three decode workers),
    then the CLI module with ``--profile DIR`` in a subprocess
    (cli_counted's checks).  DIR must hold a trace naming
    ``top2_l2_kernel`` and ``steps.`` spans.  Prints whether its poses.txt
    equals phase 4's byte for byte (the same frames, K and seed) and times
    the photo decode per frame in this process → (counts, poses.txt)."""
    import glob

    import numpy as np

    from slam_indoor_code_tpu_torch.io import native
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.io.png import write_png

    with tempfile.TemporaryDirectory() as root:
        photos, prof = (os.path.join(root, d) for d in ("photos", "prof"))
        os.makedirs(photos)
        t = time.perf_counter()
        for i, f in enumerate(frames):
            write_png(os.path.join(photos, f"frame_{i}.png"), f)
        write_s = time.perf_counter() - t
        cfg = dataclasses.replace(
            headline_config(os.path.join(root, "out")),
            photosPathPattern=os.path.join(photos, "*.png"))

        decoder = "native (libjpeg/libpng)"
        if not native.available():
            why = [ln for ln in native.build_error().splitlines()
                   if "error" in ln] or ["?"]
            decoder = (f"the port's PNG reader (io/png.py over "
                       f"native/png.cpp); the native build failed: "
                       f"{why[0].strip()[:120]}")
        t = time.perf_counter()
        src = MediaSource(photos_pattern=cfg.photosPathPattern, threads=3)
        decoded = list(src)
        decode_ms = 1e3 * (time.perf_counter() - t) / max(len(decoded), 1)
        if len(decoded) != len(frames) or not all(
                np.array_equal(a, b) for a, b in zip(decoded, frames)):
            fail("cli: the decoded photos differ from the rendered frames")

        n, n_cams, ate_pct, poses, run_s = cli_counted(
            "cli", cfg, root, scene, ("--profile", prof))
        same = poses == logged_l2["poses"]
        traces = glob.glob(os.path.join(prof, "*.json"))
        text = "".join(open(p).read() for p in traces)
        trace_mb = sum(os.path.getsize(p) for p in traces) / 1e6
    if "top2_l2_kernel" not in text or "steps." not in text:
        fail(f"cli: the trace in {len(traces)} file(s) names "
             f"top2_l2_kernel: {'top2_l2_kernel' in text}, steps. spans: "
             f"{'steps.' in text}")
    print(f"cli: exit 0, cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent (logs reloaded)  launches {json.dumps(n)}  subprocess "
          f"{run_s:.3f} s (profiled)  trace {trace_mb:.1f} MB in "
          f"{len(traces)} file(s) names top2_l2_kernel and steps. spans  "
          f"poses.txt equals the main path's byte for byte: {same}  decode "
          f"{decode_ms:.3f} ms per frame (3 workers, {os.cpu_count()} cores; "
          f"{decoder}); PNG writing {1e3 * write_s / len(frames):.1f} ms per "
          f"frame  [{card_line}]", flush=True)
    return n, poses

# ------------------------------------------------------------ media slice

# ``python -m slam_indoor_code_tpu_torch`` run through runpy so that the
# subprocess can report what the card did: each kernel's launch count, the
# plain versions' calls, the engine's bootstrap matches, slam_main's wall
# and the source frame of each camera, printed as one JSON line after the
# run with its exit code.  Several runs (their arguments separated by
# "--next") go one after the other in the one process, each preceded by a
# "run:" line and its counts set to 0 first.
CLI_RUN_TIMEOUT_S = 600      # each run of a CLI_COUNTING subprocess
CLI_COUNTING = r"""
import json, runpy, sys, time
import torch
from slam_indoor_code_tpu_torch import app
from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck
from slam_indoor_code_tpu_torch.runtime import DeviceEngine
seen = {}
init = DeviceEngine.__init__
def spy(self, *a, **kw):
    init(self, *a, **kw)
    seen["engines"].append(self)
DeviceEngine.__init__ = spy
for name in ("top2_batch_plain", "top2_pair_plain", "top2_l1_plain"):
    def counted(*a, _fn=getattr(ck, name), **kw):
        seen["plain"] += 1
        return _fn(*a, **kw)
    setattr(ck, name, counted)
slam_main = app.slam_main
def timed(*a, **kw):
    t = time.perf_counter()
    gd = slam_main(*a, **kw)
    torch.cuda.synchronize()
    seen["wall"].append(time.perf_counter() - t)
    seen["frame_ids"] = [int(i) for i in gd.frame_ids]
    return gd
app.slam_main = timed
def run(argv):
    seen.update(engines=[], wall=[], plain=0, frame_ids=[])
    for fn in (ck.top2_batch, ck.top2_pair, ck.top2_l1):
        fn.launches = 0
    ck.top2_batch.multi_lane_launches = ck.top2_batch.hamming_launches = 0
    sys.argv = ["slam_indoor_code_tpu_torch"] + argv
    t, code = time.perf_counter(), 0
    try:
        runpy.run_module("slam_indoor_code_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    print("counts: " + json.dumps({
        "top2_batch": ck.top2_batch.launches,
        "hamming": ck.top2_batch.hamming_launches,
        "lpb": ck.top2_batch.multi_lane_launches,
        "top2_pair": ck.top2_pair.launches, "top2_l1": ck.top2_l1.launches,
        "plain": seen["plain"], "slam_main_s": sum(seen["wall"]),
        "frame_ids": seen["frame_ids"], "exit": code,
        "run_s": time.perf_counter() - t,
        "match_select_calls": sum(e.match_select_calls
                                  for e in seen["engines"])}), flush=True)
runs = [[]]
for a in sys.argv[1:]:
    if a == "--next":
        runs.append([])
    else:
        runs[-1].append(a)
for argv in runs:
    print("run: " + json.dumps(argv), flush=True)
    run(argv)
"""


def cli_counted(what: str, cfg, root: str, scene, extra_args=()):
    """The configuration as JSON and K as XML under ``root``, then the CLI
    module in a subprocess under CLI_COUNTING (cli_counted_many's checks)
    → (counts, cameras, ATE %, poses.txt's text, subprocess s)."""
    runs, run_s = cli_counted_many([(what, cfg, root, extra_args)], scene)
    return (*runs[0][:4], run_s)


def cli_counted_many(jobs, scene):
    """For each job (what, configuration, root, extra arguments): the
    configuration as JSON and K as XML under its root; then the CLI module
    once per job, one after the other in one subprocess under
    CLI_COUNTING.  Holds each run's exit 0, its "map points" line, the six
    logs (reloaded: cameras >= MIN_CAMERAS at ATE < 5 %, paired with
    ground truth by the run's frame ids), and one L2 ``top2_batch`` launch
    per scan step (time.txt's "Matching time for index" lines) and per
    bootstrap ``match_select``, with no other kernel and no plain version
    → ([(counts, cameras, ATE %, poses.txt's text, the run's s)], the
    subprocess's s)."""
    import re

    from slam_indoor_code_tpu_torch.config import dump_config
    from slam_indoor_code_tpu_torch.io.xmlio import save_matrix_to_xml

    repo = os.path.dirname(os.path.abspath(__file__))
    argv, cfgs = [], []
    for what, cfg, root, extra_args in jobs:
        save_matrix_to_xml(os.path.join(root, "cam.xml"), scene.K, "K")
        cfg = dataclasses.replace(cfg, threadsCount=3,
                                  calibrationPath=os.path.join(root,
                                                               "cam.xml"))
        os.makedirs(cfg.outputDataDir, exist_ok=True)
        cfg_path = os.path.join(root, "cfg.json")
        with open(cfg_path, "w") as f:
            f.write(dump_config(cfg))
        argv += (["--next"] if argv else []) + [cfg_path, *extra_args]
        cfgs.append(cfg)
    names = ", ".join(job[0] for job in jobs)
    t = time.perf_counter()
    stdout, rc, err = counted_subprocess(names, argv, repo)
    run_s = time.perf_counter() - t
    if rc != 0:
        fail(f"{names}: exit {rc}: {err[-2000:]}")
    sections = re.split(r"^run: .*$", stdout, flags=re.M)[1:]
    if len(sections) != len(jobs):
        fail(f"{names}: {len(sections)} runs reported for {len(jobs)} in "
             f"{r.stdout[-500:]!r}")
    return [held_cli_run(job[0], cfg, scene, text)
            for job, cfg, text in zip(jobs, cfgs, sections)], run_s


def counted_subprocess(names: str, argv, repo: str):
    """CLI_COUNTING with ``argv`` in a subprocess, each of its runs given
    CLI_RUN_TIMEOUT_S from its "run:" line (the first also the start of
    the interpreter) → (stdout, exit code, stderr); a run that overruns
    kills the subprocess and fails."""
    import queue
    import threading

    with tempfile.TemporaryFile("w+") as err:
        p = subprocess.Popen([sys.executable, "-c", CLI_COUNTING, *argv],
                             stdout=subprocess.PIPE, stderr=err, text=True,
                             cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        lines: queue.Queue = queue.Queue()

        def read():
            for line in p.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=read, daemon=True).start()
        out, deadline = [], time.monotonic() + CLI_RUN_TIMEOUT_S
        while True:
            try:
                line = lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                p.kill()
                p.wait()
                fail(f"{names}: a run took more than {CLI_RUN_TIMEOUT_S} s "
                     f"after {''.join(out)[-500:]!r}")
            if line is None:
                break
            if line.startswith("run: "):
                deadline = time.monotonic() + CLI_RUN_TIMEOUT_S
            out.append(line)
        rc = p.wait()
        err.seek(0)
        return "".join(out), rc, err.read()


def held_cli_run(what: str, cfg, scene, stdout: str):
    """One CLI run's checks (cli_counted_many) on its part of the
    subprocess's output → (counts, cameras, ATE %, poses.txt, run s)."""
    import re

    import numpy as np

    from slam_indoor_code_tpu_torch.io.logs import load_global_data_from_logs

    out = cfg.outputDataDir
    m = re.search(r"map points: (\d+); cameras: (\d+)", stdout)
    c = re.search(r"^counts: (.*)$", stdout, re.M)
    if m is None or c is None:
        fail(f"{what}: no 'map points' or counts line in "
             f"{stdout[-500:]!r}")
    n_pts, n_cams = int(m.group(1)), int(m.group(2))
    n = json.loads(c.group(1))
    if n.pop("exit") != 0:
        fail(f"{what}: the CLI exited non-zero: {stdout[-500:]!r}")
    run_s = n.pop("run_s")
    for name in ("poses", "rotations", "points", "colors", "main", "time"):
        if not os.path.getsize(os.path.join(out, f"{name}.txt")):
            fail(f"{what}: {name}.txt is empty")
    gd = load_global_data_from_logs(out)
    with open(os.path.join(out, "poses.txt")) as f:
        poses = f.read()
    with open(os.path.join(out, "time.txt")) as f:
        steps = sum(ln.startswith("Matching time for index") for ln in f)
    if len(gd.rotations) != n_cams or len(gd.points) != n_pts:
        fail(f"{what}: the logs reload {len(gd.rotations)} cameras and "
             f"{len(gd.points)} points, the run printed {n_cams} and {n_pts}")
    if n_cams < MIN_CAMERAS:
        fail(f"{what}: only {n_cams}/{N_FRAMES} frames became cameras")
    fids = n.pop("frame_ids")
    if len(fids) != n_cams:
        fail(f"{what}: {len(fids)} frame ids for {n_cams} cameras")
    ate_pct = rel_ate_pct(scene, gd.rotations, gd.positions, fids)
    if not np.isfinite(ate_pct) or not ate_pct < 100 * ATE_MAX_FRAC:
        fail(f"{what}: ATE {ate_pct:.4f}% >= {100 * ATE_MAX_FRAC}% of extent")
    if n["plain"]:
        fail(f"{what}: a kernel's plain version was called {n['plain']} "
             "times on the card")
    if (n["top2_batch"] != steps + n["match_select_calls"] or steps == 0
            or n["hamming"] or n["lpb"] or n["top2_pair"] or n["top2_l1"]):
        fail(f"{what}: launches {n} for {steps} scan steps and "
             f"{n['match_select_calls']} bootstrap matches")
    return n, n_cams, ate_pct, poses, run_s


def held_to_fixtures() -> int:
    """The decoder on the card against the committed sha256 of cv2's
    decode of each fixture (the card has no cv2) → fixtures held."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import jpeg

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "slam_indoor_code_tpu_torch", "testing",
                            "jpeg_fixtures")
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        table = json.load(f)
    for name, want in table.items():
        img = jpeg.imread_rgb(os.path.join(fixtures, name))
        got = (None if img is None else
               hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest())
        if got != want["sha256"]:
            fail(f"jpeg: {name} decodes to sha256 {got}, cv2's is "
                 f"{want['sha256']}")
    return len(table)


def decode_timings(media_kw: dict, n_frames: int):
    """Two passes of ``MediaSource(**media_kw)`` with three workers → (the
    first pass's frames, its ms per frame); fails unless the second pass
    gives the same frames bit for bit."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io.media import MediaSource

    t = time.perf_counter()
    first = list(MediaSource(threads=3, **media_kw))
    ms = 1e3 * (time.perf_counter() - t) / max(len(first), 1)
    second = list(MediaSource(threads=3, **media_kw))
    if len(first) != n_frames or len(second) != n_frames or not all(
            np.array_equal(a, b) for a, b in zip(first, second)):
        fail(f"decode {media_kw}: {len(first)} and {len(second)} frames, "
             "or two passes differ")
    return first, ms


def jpeg_files(frames, root: str) -> dict:
    """The 32 headline frames as baseline 4:2:0 JPEG at quality 95 (the
    numpy writer, testing/mjpeg.py: the card has no encoder) under
    ``root``, the jpeg phase's photo glob; the same JPEG frames muxed into
    one Motion-JPEG AVI (the video phase's); as progressive JPEG at
    quality 95 (the progjpeg phase's, encoded on every core); and each
    JPEG as a one-strip YCbCr JPEG TIFF, its tables in JPEGTables (the
    tiffjpeg phase's); the glob again with the damaged phase's committed
    frames in place of the same frames → {"jpegs", "jpeg", "encode_ms",
    "avi", "parse_ms", "prog", "prog_pattern", "prog_encode_ms",
    "tiff_pattern", "damaged"}: written before fixture-clis, whose
    subprocess runs the CLI on each."""
    from concurrent.futures import ThreadPoolExecutor

    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.testing import mjpeg, photos

    out = {}
    for d in ("jpeg", "prog", "tiffjpeg", "damaged"):
        os.makedirs(os.path.join(root, d))
    t = time.perf_counter()
    jpegs = [mjpeg.encode_jpeg(f, 95) for f in frames]
    out["encode_ms"] = 1e3 * (time.perf_counter() - t) / len(frames)
    for i, data in enumerate(jpegs):
        with open(os.path.join(root, "jpeg", f"frame_{i}.jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "tiffjpeg", f"frame_{i}.tif"),
                  "wb") as f:
            f.write(photos.encode_tiff(frames[i], photometric=6,
                                       compression="jpeg",
                                       jpeg_encoder=lambda _, d=data: d))
        # the damaged phase's glob: its committed frames in place
        damaged = os.path.join(DAMAGED_FIXTURES, f"frame_{i:02d}.jpg")
        if os.path.exists(damaged):
            with open(damaged, "rb") as f:
                data = f.read()
        with open(os.path.join(root, "damaged", f"frame_{i}.jpg"),
                  "wb") as f:
            f.write(data)
    path = os.path.join(root, "seq.avi")
    h, w = frames[0].shape[:2]
    mjpeg.write_avi(path, jpegs, w, h)
    t = time.perf_counter()
    parsed = avi.AviVideo(path)
    out["parse_ms"] = 1e3 * (time.perf_counter() - t)
    parsed.close()
    if len(parsed.frames) != len(jpegs) or parsed.fourcc != b"MJPG":
        fail(f"video: the container lists {len(parsed.frames)} "
             f"{parsed.fourcc!r} frames for {len(jpegs)} written")
    t = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        prog = list(pool.map(
            lambda f: mjpeg.encode_progressive_jpeg(f, 95), frames))
    out["prog_encode_ms"] = 1e3 * (time.perf_counter() - t) / len(frames)
    for i, d in enumerate(prog):
        with open(os.path.join(root, "prog", f"frame_{i}.jpg"), "wb") as f:
            f.write(d)
    out.update(jpegs=jpegs, jpeg=os.path.join(root, "jpeg", "*.jpg"),
               damaged=os.path.join(root, "damaged", "*.jpg"),
               avi=path, prog=prog,
               prog_pattern=os.path.join(root, "prog", "*.jpg"),
               tiff_pattern=os.path.join(root, "tiffjpeg", "*.tif"))
    return out


def jpeg_phase(card_line: str, scene, frames, gd_l2, written, cli):
    """The jpeg_files glob, the CLI on it with three decode workers
    (``cli``: its run in fixture_clis).  First the decoder is held to the
    committed fixtures; then the decode is timed in this process with
    three workers and with one, and two passes must agree bit for bit →
    (counts, poses.txt, the JPEG bytes, the decoded frames)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io import jpeg, native

    held = held_to_fixtures()
    decoder = "native (libjpeg)"
    if not native.available():
        why = [ln for ln in native.build_error().splitlines()
               if "error" in ln] or ["?"]
        decoder = (f"io/jpeg.py (native/jpeg.cpp); the native libjpeg build "
                   f"failed: {why[0].strip()[:100]}")
    jpegs, encode_ms = written["jpegs"], written["encode_ms"]
    n, n_cams, ate_pct, poses, run_s, when = cli
    decoded, decode_ms = decode_timings({"photos_pattern": written["jpeg"]},
                                        len(frames))
    t = time.perf_counter()
    for data in jpegs:
        jpeg.decode(data)
    one_ms = 1e3 * (time.perf_counter() - t) / len(jpegs)
    err = max(float(np.abs(a.astype(np.int16) - b).mean())
              for a, b in zip(decoded, frames))
    if err > 3.0:
        fail(f"jpeg: decoded frames are {err:.3f} grey levels off the "
             "rendered ones on average")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"jpeg: exit 0, cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% "
          f"of extent (logs reloaded; the L2 run on the lossless frames: "
          f"{len(gd_l2.rotations)} cameras)  launches {json.dumps(n)}  "
          f"decoder {decoder}; {held} fixtures equal cv2's decode (sha256); "
          f"{sum(map(len, jpegs)) / len(jpegs) / 1e3:.1f} kB per frame, "
          f"mean |decoded - rendered| <= {err:.3f}; decode "
          f"{decode_ms:.3f} ms per frame with 3 workers ({os.cpu_count()} "
          f"cores), {one_ms:.3f} ms per frame on one thread; tracking "
          f"(slam_main in the CLI, decode overlapped) {track_ms:.3f} ms per "
          f"frame; CLI run {run_s:.3f} s ({when}); numpy encode "
          f"{encode_ms:.1f} ms per frame  [{card_line}]", flush=True)
    return n, poses, jpegs, decoded


def video_phase(card_line: str, scene, jpegs, decoded, poses_jpeg, written,
                cli):
    """The jpeg phase's JPEG frames in one Motion-JPEG AVI (jpeg_files,
    the RIFF writer of testing/mjpeg.py), the CLI on it with
    ``usePhotosCycle=false`` (``cli``: fixture_clis): its poses.txt must
    equal the jpeg run's byte for byte (the same frames); the decode is
    timed in this process, whose frames must equal the jpeg phase's →
    counts."""
    import numpy as np

    path, parse_ms = written["avi"], written["parse_ms"]
    n, n_cams, ate_pct, poses, run_s, when = cli
    frames, decode_ms = decode_timings(
        {"video_path": path, "use_photos": False}, len(jpegs))
    mb = os.path.getsize(path) / 1e6
    if not all(np.array_equal(a, b) for a, b in zip(frames, decoded)):
        fail("video: the AVI's frames differ from the JPEG files' frames")
    if poses != poses_jpeg:
        fail("video: poses.txt differs from the jpeg run's")
    print(f"video: exit 0, {len(frames)} frames ({mb:.1f} MB MJPEG AVI), "
          f"cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  "
          f"poses.txt equals the jpeg run's byte for byte  launches "
          f"{json.dumps(n)}  container parse {parse_ms:.3f} ms; decode "
          f"{decode_ms:.3f} ms per frame with 3 workers; tracking "
          f"{1e3 * n['slam_main_s'] / N_FRAMES:.3f} ms per frame; "
          f"CLI run {run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n


def held_to_video_fixtures() -> list:
    """The small committed video fixtures (testing/video_fixtures/, each
    listed in its cv2_sha256.json with the sha256 of cv2's RGB frames)
    through ``MediaSource`` on the card, frame for frame → their names."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io.media import MediaSource

    fixtures = os.path.dirname(MP4_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        table = json.load(f)
    names = list(SMALL_VIDEO_FIXTURES)
    for name in names:
        got = [hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
               for img in MediaSource(video_path=os.path.join(fixtures, name),
                                      use_photos=False)]
        if got != table[name]["rgb_sha256"]:
            fail(f"progjpeg: {name} decodes to {len(got)} frames whose "
                 "sha256 differ from cv2's")
    return names


def progjpeg_phase(card_line: str, scene, frames, decoded_jpeg, poses_jpeg,
                   written, cli):
    """The small video fixtures held to cv2's decode; the 32 headline frames
    as progressive JPEG at quality 95 in libjpeg's default script
    (jpeg_files, the numpy writer of testing/mjpeg.py: the card has no
    encoder), the CLI on the photo glob with three decode workers
    (``cli``: fixture_clis); its poses.txt must equal the jpeg run's where
    every decoded frame equals the baseline one; the decode is timed with
    three workers and with one → (counts, decode ms per frame with 3
    workers, on one thread, tracking ms per frame)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io import jpeg

    t0 = time.perf_counter()
    held = held_to_video_fixtures()
    jfix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "slam_indoor_code_tpu_torch", "testing",
                        "jpeg_fixtures")
    progressive = [n for n in sorted(os.listdir(jfix)) if "_prog_" in n]
    for name in progressive:       # held to cv2's sha256 in the jpeg phase
        with open(os.path.join(jfix, name), "rb") as f:
            if b"\xff\xc2" not in f.read():
                fail(f"progjpeg: {name} is not a progressive JPEG")
    data, encode_ms = written["prog"], written["prog_encode_ms"]
    n, n_cams, ate_pct, poses, run_s, when = cli
    decoded, decode_ms = decode_timings(
        {"photos_pattern": written["prog_pattern"]}, len(frames))
    t = time.perf_counter()
    for d in data:
        jpeg.decode(d)
    one_ms = 1e3 * (time.perf_counter() - t) / len(data)
    parted = [i for i, (a, b) in enumerate(zip(decoded, decoded_jpeg))
              if not np.array_equal(a, b)]
    if not parted and poses != poses_jpeg:
        fail("progjpeg: the decoded frames equal the baseline ones, but "
             "poses.txt differs from the jpeg run's")
    same = ("poses.txt equals the jpeg run's byte for byte (every decoded "
            "frame equal to the baseline file's)" if not parted else
            f"decoded frames part from the baseline ones at frame "
            f"{parted[0]} ({len(parted)} differ); poses.txt "
            f"{'equal' if poses == poses_jpeg else 'differs'}")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"progjpeg: {len(held)} small video fixtures equal cv2's decode "
          f"(sha256: {', '.join(held)}); {len(progressive)} progressive JPEG "
          f"fixtures among the jpeg phase's; exit 0, cameras "
          f"{n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  {same}  "
          f"launches {json.dumps(n)}  "
          f"{sum(map(len, data)) / len(data) / 1e3:.1f} kB per frame (10 "
          f"scans); decode {decode_ms:.3f} ms per FHD frame with 3 workers "
          f"({os.cpu_count()} cores), {one_ms:.3f} ms on one thread; "
          f"tracking {track_ms:.3f} ms per frame; CLI run {run_s:.3f} s "
          f"({when}); numpy encode {encode_ms:.1f} ms per frame on "
          f"{os.cpu_count()} threads; phase "
          f"{time.perf_counter() - t0:.1f} s  [{card_line}]", flush=True)
    return n, decode_ms, one_ms, track_ms


def tiffjpeg_phase(card_line: str, decoded_jpeg, poses_jpeg, jpeg_counts,
                   written, cli):
    """The jpeg phase's JPEG frames as one-strip YCbCr JPEG TIFFs, their
    tables in JPEGTables (jpeg_files): each decoded on one thread by
    io/tiff.py (libtiff's JPEG codec over native/jpeg.cpp) and timed, equal
    to the port's decode of the same JPEG bit for bit; the CLI on the glob
    (``cli``: fixture_clis): poses.txt equal to the jpeg run's byte for
    byte, the jpeg run's ``top2_batch`` launches → (counts, decode ms per
    frame on one thread, tracking ms per frame)."""
    import glob

    import numpy as np

    from slam_indoor_code_tpu_torch.io import photo

    paths = sorted(glob.glob(written["tiff_pattern"]),
                   key=lambda p: (len(p), p))
    t = time.perf_counter()
    got = [photo.imread_rgb(p) for p in paths]
    one_ms = 1e3 * (time.perf_counter() - t) / max(len(paths), 1)
    if len(got) != len(decoded_jpeg) or not all(
            g is not None and np.array_equal(g, d)
            for g, d in zip(got, decoded_jpeg)):
        fail("tiffjpeg: a JPEG TIFF's frame differs from the port's decode "
             "of its JPEG")
    n, n_cams, ate_pct, poses, run_s, when = cli
    if poses != poses_jpeg:
        fail("tiffjpeg: poses.txt differs from the jpeg run's")
    if n["top2_batch"] != jpeg_counts["top2_batch"]:
        fail(f"tiffjpeg: {n['top2_batch']} top2_batch launches, the jpeg "
             f"run's {jpeg_counts['top2_batch']}")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    kb = sum(os.path.getsize(p) for p in paths) / len(paths) / 1e3
    print(f"tiffjpeg: {len(paths)} one-strip YCbCr JPEG TIFFs "
          f"({kb:.1f} kB per frame) decode equal to the port's JPEG decode "
          f"bit for bit; exit 0, cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  poses.txt equals the jpeg run's byte "
          f"for byte  launches {json.dumps(n)}  decode {one_ms:.3f} ms per "
          f"FHD frame on one thread; tracking {track_ms:.3f} ms per frame; "
          f"CLI run {run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, one_ms, track_ms


DAMAGED_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "slam_indoor_code_tpu_torch", "testing",
                                "jpeg_fixtures", "damaged")


def damaged_phase(card_line: str, written, cli):
    """The committed damaged FHD frames (the card has no encoder and no
    cv2), each decoded by io/photo.py on one thread, timed, and held to
    the committed sha256 of cv2's decode; the jpeg phase's glob with them
    in place of the same frames (jpeg_files' "damaged") through
    ``MediaSource``: 32 frames, none skipped; the CLI on it (``cli``:
    fixture_clis), with the jpeg phase's checks → (counts, decode ms of
    each damaged frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import photo
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    with open(os.path.join(DAMAGED_FIXTURES, "cv2_sha256_damaged.json")) as f:
        table = json.load(f)
    decode_ms = {}
    for name in sorted(table):
        with open(os.path.join(DAMAGED_FIXTURES, name), "rb") as f:
            data = f.read()
        t = time.perf_counter()
        img = photo.decode(data)
        decode_ms[name] = 1e3 * (time.perf_counter() - t)
        got = (None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest())
        if got != table[name]:
            fail(f"damaged: {name} decodes to sha256 {got}, cv2's is "
                 f"{table[name]}")
    n_read = sum(1 for _ in MediaSource(photos_pattern=written["damaged"],
                                        threads=3))
    if n_read != N_FRAMES:
        fail(f"damaged: the glob gives {n_read} frames of {N_FRAMES}")
    n, n_cams, ate_pct, poses, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    ms = "  ".join(f"{k} {v:.3f}" for k, v in decode_ms.items())
    print(f"damaged: {len(table)} damaged FHD JPEG frames equal cv2's decode "
          f"(sha256); decode ms on one thread: {ms}; the glob with them in "
          f"place: {n_read}/{N_FRAMES} frames read; exit 0, cameras "
          f"{n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  launches "
          f"{json.dumps(n)}; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms


JP2_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "slam_indoor_code_tpu_torch", "testing",
                            "photo_fixtures", "headline_jp2")


def jp2_phase(card_line: str, cli):
    """The committed JP2 fixture of the 32 headline frames (Pillow's 9/7,
    RPCL, 1024x1024 tiles, 256x256 precincts, three layers, PLT: the card
    has no encoder): each frame decoded by io/jp2.py (native/jp2.cpp) on
    one thread, timed, and held to the committed sha256 of cv2's decode;
    the CLI on the glob (``cli``: fixture_clis), with the jpeg phase's
    checks → (counts, decode ms per frame on one thread, tracking ms per
    frame)."""
    import glob
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import photo

    with open(os.path.join(JP2_FIXTURES, "cv2_sha256.json")) as f:
        table = json.load(f)
    paths = sorted(glob.glob(os.path.join(JP2_FIXTURES, "frame_*.jp2")))
    if len(paths) != N_FRAMES or sorted(table) != [os.path.basename(p)
                                                   for p in paths]:
        fail(f"jp2: {len(paths)} fixture frames for {len(table)} sha256")
    spent = 0.0
    for p in paths:
        t = time.perf_counter()
        img = photo.imread_rgb(p)
        spent += time.perf_counter() - t
        got = (None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest())
        if got != table[os.path.basename(p)]:
            fail(f"jp2: {os.path.basename(p)} decodes to sha256 {got}, "
                 f"cv2's is {table[os.path.basename(p)]}")
    one_ms = 1e3 * spent / len(paths)
    n, n_cams, ate_pct, poses, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    print(f"jp2: {len(paths)} FHD JP2 frames ({mb:.3f} MB) equal cv2's "
          f"decode (sha256); exit 0, cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  launches {json.dumps(n)}  decode "
          f"{one_ms:.3f} ms per FHD frame on one thread; tracking "
          f"{track_ms:.3f} ms per frame; CLI run {run_s:.3f} s ({when})  "
          f"[{card_line}]", flush=True)
    return n, one_ms, track_ms


PHOTO_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "slam_indoor_code_tpu_torch", "testing",
                              "photo_fixtures")


def photo_writers():
    """The FHD glob's formats, cycled over the frames: (name, extension,
    writer of testing/photos.py); every extension is three letters long
    (``wbp`` for WebP: the readers sniff the bytes), so that the natural
    sort keeps frame order."""
    import numpy as np

    from slam_indoor_code_tpu_torch.testing import photos

    return (
        ("P6 PPM", "ppm", photos.encode_ppm),
        ("24-bit BMP", "bmp", photos.encode_bmp),
        ("tiled Deflate TIFF, predictor 2", "tif",
         lambda f: photos.encode_tiff(f, compression="deflate", predictor=2,
                                      tile=(256, 256))),
        ("PackBits TIFF strips", "tif",
         lambda f: photos.encode_tiff(f, compression="packbits",
                                      rows_per_strip=64)),
        ("16-bit PNG", "png",
         lambda f: photos.encode_png16(f.astype(np.uint16) * 257)),
        ("all-Paeth PNG", "png", photos.encode_png_paeth),
        ("lossless WebP", "wbp", photos.encode_webp_lossless),
        ("animated lossless WebP", "wbp", photos.encode_webp_animated),
        ("24-bit Sun raster", "ras", photos.encode_sun_raster),
        ("CMYK TIFF, K = 0", "tif",
         lambda f: photos.encode_tiff(np.concatenate(
             [255 - f, np.zeros_like(f[..., :1])], axis=-1),
             photometric=5)))


def held_to_photo_fixtures() -> int:
    """Each committed photo fixture (every ``cv2_sha256*.json`` table)
    through ``MediaSource`` on the card against the committed sha256 of
    cv2's decode, or no frame where cv2 gives none (a null entry) →
    fixtures held."""
    import glob

    from slam_indoor_code_tpu_torch.io.media import MediaSource

    held = 0
    for table_path in sorted(glob.glob(os.path.join(PHOTO_FIXTURES,
                                                    "cv2_sha256*.json"))):
        with open(table_path) as f:
            table = json.load(f)
        for name, want in table.items():
            got = [video_sha(img) for img in MediaSource(
                photos_pattern=glob.escape(os.path.join(PHOTO_FIXTURES,
                                                        name)))]
            if got != ([] if want is None else [want["sha256"]]):
                fail(f"photos: {name} decodes to {got}, cv2's is "
                     f"{want and want['sha256']}")
        held += len(table)
    return held


def write_photo_glob(frames, root: str) -> dict:
    """The 32 frames as one glob cycling photo_writers' formats (names of
    one length), each format's frames also in a directory of their own,
    and N_GIFS frames as GIF of the 3-3-2 palette, written on three
    threads under ``root`` → {"pattern", "by_kind", "gifs",
    "palette_images", "write_ms" per frame}."""
    from concurrent.futures import ThreadPoolExecutor

    from slam_indoor_code_tpu_torch.testing import photos

    kinds = photo_writers()
    mixed = os.path.join(root, "photos")
    by_kind = [os.path.join(root, f"kind{k}") for k in range(len(kinds))]
    gifs = os.path.join(root, "gif")
    for d in [mixed, gifs] + by_kind:
        os.makedirs(d)

    def write(i):
        k = i % len(kinds)
        data = kinds[k][2](frames[i])
        name = f"frame_{i:02d}.{kinds[k][1]}"
        for d in (mixed, by_kind[k]):
            with open(os.path.join(d, name), "wb") as fh:
                fh.write(data)

    def write_gif(i):
        index, palette = photos.quantize_332(frames[i])
        with open(os.path.join(gifs, f"frame_{i:02d}.gif"), "wb") as fh:
            fh.write(photos.encode_gif(index, palette))
        return palette[index]

    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(write, range(len(frames))))
        palette_images = list(pool.map(write_gif, range(N_GIFS)))
    write_ms = 1e3 * (time.perf_counter() - t) / len(frames)
    return {"pattern": os.path.join(mixed, "frame_*"), "by_kind": by_kind,
            "gifs": gifs, "palette_images": palette_images,
            "write_ms": write_ms}


def timed_decodes(name: str, paths: list) -> tuple[float, float]:
    """Each of ``paths`` decoded by io/photo.py on one thread, then all of
    them through ``MediaSource`` with three workers → (ms per file on one
    thread, ms per file with three workers)."""
    from slam_indoor_code_tpu_torch.io import photo
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    t = time.perf_counter()
    for p in paths:
        photo.imread_rgb(p)
    one_ms = 1e3 * (time.perf_counter() - t) / len(paths)
    t = time.perf_counter()
    got = list(MediaSource(photos_pattern=os.path.join(
        os.path.dirname(paths[0]), "*"), threads=3))
    three_ms = 1e3 * (time.perf_counter() - t) / len(paths)
    if len(got) != len(paths):
        fail(f"photos: {name}: {len(got)} frames for {len(paths)}")
    return one_ms, three_ms


N_GIFS = 4


def photos_phase(card_line: str, frames, cli_counts, cli_poses, written,
                 cli):
    """The committed photo fixtures held to cv2's decode; the 32 frames as
    one mixed-format glob (``written``: write_photo_glob's, before
    fixture_clis): every frame decoded equal to the rendered one, then
    the CLI on it (``cli``: its run in fixture_clis): 32/32 cameras,
    poses.txt equal to the cli phase's, its ``top2_batch`` launches; the
    jpeg phase's first frame with EXIF Orientation 6 turned as cv2 turns
    it; N_GIFS frames quantised to the fixed 3-3-2 palette as GIF, each
    decoded to palette[index]; the first frame as PFM (equal to it) and as
    Radiance HDR (its RGBE rounding: within 1 grey level, and equal to
    numpy's decode of the RGBE); each format's decode timed on one thread
    and with three workers → (counts, {format: (ms on one thread, ms with
    3 workers)}, tracking ms per frame)."""
    import glob

    import numpy as np

    from slam_indoor_code_tpu_torch.io import native, photo
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg, photos

    t0 = time.perf_counter()
    held = held_to_photo_fixtures()
    decoder = "native (libjpeg/libpng)" if native.available() else \
        "the port's readers (io/photo.py)"
    kinds = photo_writers()
    decoded = list(MediaSource(photos_pattern=written["pattern"], threads=3))
    if len(decoded) != len(frames) or not all(
            np.array_equal(a, b) for a, b in zip(decoded, frames)):
        fail(f"photos: {len(decoded)} frames decoded for {len(frames)}, "
             "or one differs from its rendered frame")
    del decoded
    gif_paths = sorted(glob.glob(os.path.join(written["gifs"], "*")))
    for p, want in zip(gif_paths, written["palette_images"]):
        got = photo.imread_rgb(p)
        if got is None or not np.array_equal(got, want):
            fail(f"photos: {os.path.basename(p)} does not decode to "
                 "palette[index]")
    n, n_cams, ate_pct, poses, run_s, when = cli
    times = {name: timed_decodes(name, sorted(glob.glob(
        os.path.join(written["by_kind"][k], "*")))) for k, (name, _, _) in
        enumerate(kinds)}
    times["GIF, 3-3-2 palette"] = timed_decodes("GIF", gif_paths)
    floats = {}
    for name, data in (("PFM", photos.encode_pfm(frames[0])),
                       ("Radiance HDR", photos.encode_hdr(frames[0]))):
        t = time.perf_counter()
        got = photo.decode(data)
        floats[name] = 1e3 * (time.perf_counter() - t)
        if got is None or got.shape != frames[0].shape:
            fail(f"photos: the FHD {name} frame does not decode")
        if name == "PFM" and not np.array_equal(got, frames[0]):
            fail("photos: the FHD PFM frame differs from the rendered one")
        if name == "Radiance HDR":
            px = photos.rgbe(frames[0]).astype(np.float64)
            want = np.where(px[..., 3:] > 0, np.rint(
                px[..., :3] * 255.0 * np.exp2(px[..., 3:] - 136.0)), 0)
            if (not np.array_equal(got, np.clip(want, 0, 255))
                    or np.abs(got.astype(int) - frames[0]).max() > 1):
                fail("photos: the FHD HDR frame differs from its RGBE")
    if n_cams != N_FRAMES:
        fail(f"photos: {n_cams}/{N_FRAMES} cameras")
    if poses != cli_poses:
        fail("photos: poses.txt differs from the cli phase's")
    if n["top2_batch"] != cli_counts["top2_batch"]:
        fail(f"photos: {n['top2_batch']} top2_batch launches, the cli "
             f"phase's {cli_counts['top2_batch']}")
    jpg = mjpeg.encode_jpeg(frames[0], 95)
    plain = photo.decode(jpg)
    turned = photo.decode(photos.insert_exif(jpg, 6))
    if plain is None or turned is None or not np.array_equal(
            turned, np.rot90(plain, -1)):
        fail("photos: EXIF Orientation 6 does not turn the FHD JPEG a "
             "quarter clockwise")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    per = "; ".join(f"{name} {a:.3f} ms on one thread, {b:.3f} ms with 3 "
                    f"workers" for name, (a, b) in times.items())
    print(f"photos: {held} fixtures equal cv2's decode (sha256, or no "
          f"frame) through MediaSource ({decoder}); {len(frames)} FHD "
          f"frames in {len(kinds)} formats decode to the rendered frames; "
          f"{len(gif_paths)} FHD GIFs decode to palette[index]; exit 0, "
          f"cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  "
          f"poses.txt equals the cli phase's byte for byte  launches "
          f"{json.dumps(n)}  EXIF 6 turns the FHD JPEG to "
          f"{turned.shape[1]}x{turned.shape[0]} as cv2 does; decode per "
          f"FHD frame ({os.cpu_count()} cores): {per}; FHD PFM "
          f"{floats['PFM']:.3f} ms, FHD Radiance HDR "
          f"{floats['Radiance HDR']:.3f} ms on one thread; tracking "
          f"{track_ms:.3f} ms per frame; CLI run {run_s:.3f} s ({when}); "
          f"numpy writing {written['write_ms']:.1f} ms per frame (3 "
          f"threads, before fixture-clis); phase "
          f"{time.perf_counter() - t0:.1f} s  [{card_line}]", flush=True)
    times["PFM"] = (floats["PFM"], float("nan"))
    times["Radiance HDR"] = (floats["Radiance HDR"], float("nan"))
    return n, times, track_ms


SMALL_VIDEO_FIXTURES = ("resync_fmp4.avi", "xvid_tagged.avi", "odd_vp8.webm",
                        "odd_i420.avi", "y800.avi", "mjpeg.mov")


MP4_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "slam_indoor_code_tpu_torch", "testing",
                           "video_fixtures", "headline_mp4v.mp4")


def mp4_phase(card_line: str, scene, cli):
    """The committed fixture (the 32 headline frames as OpenCV's ``mp4v``
    writer makes them: the card has no encoder): the container parsed and
    timed; every frame decoded on one thread, timed, and held to the
    committed sha256 of cv2's RGB frames and Y planes (and the small
    AC-prediction/DQUANT fixture to its RGB sha256); the same samples
    muxed into an XVID AVI (testing/mjpeg.py, the headers in front of the
    first), whose frames through ``MediaSource`` must equal the MP4's; then
    the CLI on the .mp4 with ``usePhotosCycle=false`` (``cli``:
    fixture_clis) → counts."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import mp4, mpeg4
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    fixtures = os.path.dirname(MP4_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(MP4_FIXTURE)]
    t = time.perf_counter()
    video = mp4.Mp4Video(MP4_FIXTURE)
    parse_ms = 1e3 * (time.perf_counter() - t)
    samples = [video.read(fr) for fr in video.frames]
    extradata, w, h = video.extradata, video.width, video.height
    video.close()
    if len(samples) != table["frames"] or (h, w) != tuple(table["shape"][:2]):
        fail(f"mp4: the fixture parses to {len(samples)} samples at {h}x{w}")
    dec = mpeg4.Decoder(extradata)
    t = time.perf_counter()
    rgb = [dec.decode(s) for s in samples]
    decode_ms = 1e3 * (time.perf_counter() - t) / len(samples)
    dec.close()
    dec = mpeg4.Decoder(extradata)
    luma = [dec.decode_yuv(s)[0] for s in samples]
    dec.close()
    if [sha(f) for f in rgb] != table["rgb_sha256"]:
        fail("mp4: the decoded RGB frames differ from cv2's (sha256)")
    if [sha(y) for y in luma] != table["y_sha256"]:
        fail("mp4: the decoded Y planes differ from cv2's (sha256)")
    aq = os.path.join(fixtures, "acpred_dquant_xvid.avi")
    if [sha(f) for f in MediaSource(video_path=aq, use_photos=False)
        ] != tables[os.path.basename(aq)]["rgb_sha256"]:
        fail("mp4: the AC-prediction/DQUANT fixture differs from cv2's "
             "decode (sha256)")
    with tempfile.TemporaryDirectory() as root:
        avi_path = os.path.join(root, "seq.avi")
        mjpeg.write_avi(avi_path, [extradata + samples[0]] + samples[1:],
                        w, h, fourcc=b"XVID")
        from_avi = list(MediaSource(video_path=avi_path, use_photos=False))
        from_mp4 = list(MediaSource(video_path=MP4_FIXTURE,
                                    use_photos=False))
        if len(from_avi) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_avi, rgb)):
            fail("mp4: the XVID AVI's frames differ from the MP4's")
        if len(from_mp4) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_mp4, rgb)):
            fail("mp4: MediaSource's frames differ from the decoder's")
        n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"mp4: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(MP4_FIXTURE) / 1e6:.2f} MB mp4v, MPEG-4 Part "
          f"2) equal to cv2's decode (sha256 of RGB and Y; the AC-prediction/"
          f"DQUANT fixture's too), the XVID AVI's equal the MP4's; cameras "
          f"{n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  launches {json.dumps(n)}  container "
          f"parse {parse_ms:.3f} ms; decode {decode_ms:.3f} ms per frame on "
          f"one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n


ASP_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                           "headline_asp_packed.avi")
# MPEG-4 Advanced Simple Profile, small: B-VOPs with video packets;
# 4MV, quarter-pel and B-VOPs at 38x54; loaded MPEG quantisation
# matrices; DivX's packed bitstream; Xvid 5's and DivX 5.01's per-build
# workarounds; FFmpeg's inexact 8-wide no-rounding average; B-frames in
# MP4 (ctts, an edit list).
ASP_SMALL_FIXTURES = ("asp_b_resync.avi", "asp_qpel_mv4_odd.avi",
                      "asp_mpeg_matrices.avi", "asp_packed_divx.avi",
                      "asp_xvid_edge.avi", "asp_divx_qpel_chroma.avi",
                      "asp_zero_no_rnd.avi", "asp_ctts.mp4")
# the headline's 32 FHD frames coded interlaced (field DCT, field vectors,
# field direct mode, the alternate scan, B-VOPs) into an XVID AVI, its
# sha256 libavcodec's own decode's (cv2 returns uninitialised memory for
# interlaced frames); eight FHD frames with data partitioning
ASP_IL_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                              "headline_asp_interlaced.avi")
ASP_DP_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                              "asp_dp_fhd.avi")


def asp_phase(card_line: str, scene, cli, cli_il):
    """MPEG-4 Advanced Simple Profile, as Xvid and DivX code it: the small
    ASP fixtures and the committed FHD one (the 32 headline frames coded by
    libavcodec with B-VOPs, 4MV, quarter-pel and MPEG quantisation, packed
    as DivX packs B-VOPs into a DX50 AVI: the card has no encoder) held
    frame by frame to the committed sha256 of cv2's RGB frames (through
    ``MediaSource``) and Y planes (through the decoder, in display
    order); the FHD fixture decoded on one thread and timed; then the CLI
    on it with ``usePhotosCycle=false`` (``cli``: fixture_clis).  The
    interlaced FHD fixture and the data-partitioned one held the same way
    (the first to libavcodec's decode's sha256), with the decoder's counts
    of field-DCT, field-predicted and field-direct macroblocks and of
    partitioned packets; the interlaced one timed and run through the CLI
    (``cli_il``): all 32 cameras, N_FRAMES - 1 ``top2_batch`` launches →
    (counts, decode ms per frame, tracking ms per frame, the interlaced
    run's counts, its decode ms per frame, its tracking ms per frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi, mpeg4
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def shown(video, dec, decode, flush):
        """The frames the container shows, in display order."""
        out = []
        for i, fr in enumerate(video.frames):
            img = decode(video.read(fr), i)
            if dec.failed:
                return out
            if img is not None and video.frames[dec.tag][2]:
                out.append(img)
        img = flush()
        if img is not None and video.frames[dec.tag][2]:
            out.append(img)
        return out

    fixtures = os.path.dirname(ASP_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    names = ASP_SMALL_FIXTURES + (os.path.basename(ASP_FIXTURE),)
    for name in names:
        path, want = os.path.join(fixtures, name), tables[name]
        got = [sha(f) for f in MediaSource(video_path=path,
                                           use_photos=False)]
        if got != want["rgb_sha256"]:
            fail(f"asp: {name}: {len(got)} frames, RGB sha256 differ from "
                 f"cv2's {want['frames']}")
        video = avi.open_video(path)
        dec = mpeg4.Decoder(video.extradata, video.fourcc)
        luma = [p[0] for p in shown(video, dec, dec.decode_yuv,
                                    dec.flush_yuv)]
        dec.close()
        video.close()
        if [sha(y) for y in luma] != want["y_sha256"]:
            fail(f"asp: {name}: the Y planes differ from cv2's (sha256)")
    t = time.perf_counter()
    video = avi.open_video(ASP_FIXTURE)
    parse_ms = 1e3 * (time.perf_counter() - t)
    dec = mpeg4.Decoder(video.extradata, video.fourcc)
    packed = sum(video.read(fr).count(b"\0\0\1\xb6") == 2
                 for fr in video.frames)
    t = time.perf_counter()
    rgb = shown(video, dec, dec.decode, dec.flush)
    decode_ms = 1e3 * (time.perf_counter() - t) / max(len(rgb), 1)
    dec.close()
    video.close()
    table = tables[os.path.basename(ASP_FIXTURE)]
    if len(rgb) != N_FRAMES or [sha(f) for f in rgb] != table["rgb_sha256"]:
        fail(f"asp: the FHD fixture decodes to {len(rgb)} frames that "
             "differ from cv2's (sha256)")
    n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"asp: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(ASP_FIXTURE) / 1e6:.2f} MB DX50 AVI, MPEG-4 "
          f"ASP: B-VOPs, 4MV, quarter-pel, MPEG quantisation, {packed} "
          f"samples packing a B-VOP behind a P-VOP) equal to cv2's decode "
          f"(sha256 of RGB and Y), {len(names) - 1} small ASP fixtures too; "
          f"cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  "
          f"launches {json.dumps(n)}  container parse {parse_ms:.3f} ms; "
          f"decode {decode_ms:.3f} ms per FHD frame on one thread; tracking "
          f"{track_ms:.3f} ms per frame; CLI run {run_s:.3f} s ({when})  "
          f"[{card_line}]", flush=True)
    # interlace and data partitioning
    counts = {}
    for path in (ASP_IL_FIXTURE, ASP_DP_FIXTURE):
        name, want = os.path.basename(path), tables[os.path.basename(path)]
        got = [sha(f) for f in MediaSource(video_path=path,
                                           use_photos=False)]
        if got != want["rgb_sha256"]:
            fail(f"asp: {name}: {len(got)} frames, RGB sha256 differ from "
                 f"the recorded {want['frames']}")
        video = avi.open_video(path)
        dec = mpeg4.Decoder(video.extradata, video.fourcc)
        t = time.perf_counter()
        luma = [p[0] for p in shown(video, dec, dec.decode_yuv,
                                    dec.flush_yuv)]
        counts[name] = (dec.stats(), 1e3 * (time.perf_counter() - t)
                        / max(len(luma), 1))
        dec.close()
        video.close()
        if [sha(y) for y in luma] != want["y_sha256"]:
            fail(f"asp: {name}: the Y planes differ from the recorded "
                 "sha256")
    il, il_ms = counts[os.path.basename(ASP_IL_FIXTURE)]
    dp, _ = counts[os.path.basename(ASP_DP_FIXTURE)]
    if not (il["interlaced_vops"] == N_FRAMES and il["field_dct_mbs"] > 0
            and il["field_mc_mbs"] > 0 and il["field_direct_mbs"] > 0
            and il["alternate_scan_vops"] == N_FRAMES):
        fail(f"asp: the interlaced fixture does not use its tools: {il}")
    if dp["partitioned_packets"] <= dp["vops"] - dp["b_vops"]:
        fail(f"asp: the partitioned fixture does not use its tool: {dp}")
    t = time.perf_counter()
    video = avi.open_video(ASP_IL_FIXTURE)
    dec = mpeg4.Decoder(video.extradata, video.fourcc)
    rgb = shown(video, dec, dec.decode, dec.flush)
    il_rgb_ms = 1e3 * (time.perf_counter() - t) / max(len(rgb), 1)
    dec.close()
    video.close()
    n_il, cams_il, ate_il, _, run_il, when_il = cli_il
    if cams_il != N_FRAMES or n_il["top2_batch"] != N_FRAMES - 1:
        fail(f"asp: the interlaced CLI run: {cams_il}/{N_FRAMES} cameras, "
             f"launches {n_il}")
    track_il = 1e3 * n_il["slam_main_s"] / N_FRAMES
    print(f"asp (interlaced): exit 0, {len(rgb)} frames "
          f"({os.path.getsize(ASP_IL_FIXTURE) / 1e6:.2f} MB XVID AVI: "
          f"{il['field_dct_mbs']} field-DCT, {il['field_mc_mbs']} "
          f"field-predicted and {il['field_direct_mbs']} field-direct "
          f"macroblocks, {il['b_vops']} B-VOPs, the alternate scan) equal to "
          f"libavcodec's decode (sha256 of RGB and Y); the data-partitioned "
          f"FHD fixture's {dp['vops']} frames ({dp['partitioned_packets']} "
          f"partitioned packets) equal to cv2's; cameras {cams_il}/"
          f"{N_FRAMES}  ATE {ate_il:.4f}% of extent  launches "
          f"{json.dumps(n_il)}; decode {il_ms:.3f} ms per FHD frame on one "
          f"thread ({il_rgb_ms:.3f} with RGB); tracking {track_il:.3f} ms "
          f"per frame; CLI run {run_il:.3f} s ({when_il})  [{card_line}]",
          flush=True)
    return n, decode_ms, track_ms, n_il, il_ms, track_il


WEBM_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                            "headline_vp8.webm")


def webm_phase(card_line: str, scene, cli):
    """The committed fixture (the 32 headline frames as OpenCV's ``VP80``
    writer makes them into WebM: the card has no encoder): the Matroska
    container parsed and timed; every frame decoded on one thread, timed,
    and held to the committed sha256 of cv2's RGB frames and Y planes; the
    same frames muxed into a VP80 AVI (testing/mjpeg.py), whose frames
    through ``MediaSource`` must equal the WebM's; then the CLI on the
    .webm with ``usePhotosCycle=false`` (``cli``: fixture_clis) →
    (counts, decode ms per frame, tracking ms per frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import matroska, vp8
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    with open(os.path.join(os.path.dirname(WEBM_FIXTURE),
                           "cv2_sha256.json")) as f:
        table = json.load(f)[os.path.basename(WEBM_FIXTURE)]
    t = time.perf_counter()
    video = matroska.MkvVideo(WEBM_FIXTURE)
    parse_ms = 1e3 * (time.perf_counter() - t)
    data = [video.read(fr) for fr in video.frames]
    codec, w, h = video.codec, video.width, video.height
    video.close()
    if (codec != "vp8" or len(data) != table["frames"]
            or (h, w) != tuple(table["shape"][:2])):
        fail(f"webm: the fixture parses to {len(data)} {codec} frames at "
             f"{h}x{w}")
    dec = vp8.Decoder()
    t = time.perf_counter()
    rgb = [dec.decode(d) for d in data]
    decode_ms = 1e3 * (time.perf_counter() - t) / len(data)
    dec.close()
    dec = vp8.Decoder()
    luma = [dec.decode_yuv(d)[0] for d in data]
    dec.close()
    if [sha(f) for f in rgb] != table["rgb_sha256"]:
        fail("webm: the decoded RGB frames differ from cv2's (sha256)")
    if [sha(y) for y in luma] != table["y_sha256"]:
        fail("webm: the decoded Y planes differ from cv2's (sha256)")
    with tempfile.TemporaryDirectory() as root:
        avi_path = os.path.join(root, "seq.avi")
        mjpeg.write_avi(avi_path, data, w, h, fourcc=b"VP80")
        from_avi = list(MediaSource(video_path=avi_path, use_photos=False))
        from_webm = list(MediaSource(video_path=WEBM_FIXTURE,
                                     use_photos=False))
        if len(from_avi) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_avi, rgb)):
            fail("webm: the VP80 AVI's frames differ from the WebM's")
        if len(from_webm) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_webm, rgb)):
            fail("webm: MediaSource's frames differ from the decoder's")
        n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"webm: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(WEBM_FIXTURE) / 1e6:.2f} MB WebM, VP8) equal "
          f"to cv2's decode (sha256 of RGB and Y), the VP80 AVI's equal "
          f"the WebM's; cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent  launches {json.dumps(n)}  container parse "
          f"{parse_ms:.3f} ms; decode {decode_ms:.3f} ms per FHD frame on "
          f"one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms, track_ms


VP9_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                           "headline_vp9.webm")
# VP9, small: cv2's VP90 writer into WebM, AVI and MP4 (vp09); lossless;
# segmentation (aq-mode 3); error-resilient and frame-parallel; 97x131
VP9_SMALL_FIXTURES = ("vp9_cv2.webm", "vp9_cv2.avi", "vp9_cv2.mp4",
                      "vp9_lossless.webm", "vp9_aq.webm", "vp9_er_fp.webm",
                      "vp9_odd.webm")


def vp9_phase(card_line: str, scene, cli):
    """The committed fixture (the 32 headline frames coded by libvpx-vp9 in
    two passes, muxed into WebM: the card has no encoder): the Matroska
    container parsed and timed; every packet decoded on one thread, timed,
    and held to the committed sha256 of cv2's RGB frames and Y planes; the
    small VP9 fixtures held to theirs (RGB through ``MediaSource``, Y
    through the decoder); the same packets muxed into a VP90 AVI
    (testing/mjpeg.py), whose frames through ``MediaSource`` must equal
    the WebM's; then the CLI on the .webm with ``usePhotosCycle=false``
    (``cli``: fixture_clis) → (counts, decode ms per frame, tracking ms per
    frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi, matroska, vp9
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def luma(path):
        video = avi.open_video(path)
        dec = vp9.Decoder()
        out = []
        for fr in video.frames:
            planes = dec.decode_yuv(video.read(fr))
            if dec.failed:
                break
            if planes is not None:
                out.append(planes[0])
        video.close()
        dec.close()
        return out

    fixtures = os.path.dirname(VP9_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(VP9_FIXTURE)]
    t = time.perf_counter()
    video = matroska.MkvVideo(VP9_FIXTURE)
    parse_ms = 1e3 * (time.perf_counter() - t)
    data = [video.read(fr) for fr in video.frames]
    codec, w, h = video.codec, video.width, video.height
    video.close()
    if (codec != "vp9" or len(data) != table["frames"]
            or (h, w) != tuple(table["shape"][:2])):
        fail(f"vp9: the fixture parses to {len(data)} {codec} packets at "
             f"{h}x{w}")
    dec = vp9.Decoder()
    t = time.perf_counter()
    rgb = [dec.decode(d) for d in data]
    decode_ms = 1e3 * (time.perf_counter() - t) / len(data)
    stats = dec.stats()
    dec.close()
    if any(f is None for f in rgb) or [sha(f) for f in rgb
                                       ] != table["rgb_sha256"]:
        fail("vp9: the decoded RGB frames differ from cv2's (sha256)")
    if [sha(y) for y in luma(VP9_FIXTURE)] != table["y_sha256"]:
        fail("vp9: the decoded Y planes differ from cv2's (sha256)")
    if not (stats["hidden"] > 0 and stats["compound_blocks"] > 0
            and stats["tile_cols"] == 4 and stats["adapted"] > 0):
        fail(f"vp9: the fixture does not use its tools: {stats}")
    for name in VP9_SMALL_FIXTURES:
        path = os.path.join(fixtures, name)
        want = tables[name]
        got = [sha(f) for f in MediaSource(video_path=path, use_photos=False)]
        if got != want["rgb_sha256"] or [sha(y) for y in luma(path)
                                         ] != want["y_sha256"]:
            fail(f"vp9: the small fixture {name} differs from cv2's decode "
                 f"(sha256)")
    with tempfile.TemporaryDirectory() as root:
        avi_path = os.path.join(root, "seq.avi")
        mjpeg.write_avi(avi_path, data, w, h, fourcc=b"VP90")
        from_avi = list(MediaSource(video_path=avi_path, use_photos=False))
        from_webm = list(MediaSource(video_path=VP9_FIXTURE,
                                     use_photos=False))
        if len(from_avi) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_avi, rgb)):
            fail("vp9: the VP90 AVI's frames differ from the WebM's")
        if len(from_webm) != len(rgb) or not all(
                np.array_equal(a, b) for a, b in zip(from_webm, rgb)):
            fail("vp9: MediaSource's frames differ from the decoder's")
        n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"vp9: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(VP9_FIXTURE) / 1e6:.2f} MB WebM, VP9 profile "
          f"0: {stats['hidden']} hidden alt-ref frames, "
          f"{stats['compound_blocks']} compound blocks, {stats['tile_cols']} "
          f"tile columns) equal to cv2's decode (sha256 of RGB and Y; the "
          f"{len(VP9_SMALL_FIXTURES)} small fixtures' too), the VP90 AVI's "
          f"equal the WebM's; cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  launches {json.dumps(n)}  container "
          f"parse {parse_ms:.3f} ms; decode {decode_ms:.3f} ms per FHD frame "
          f"on one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms, track_ms


MPEG2_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                             "headline_mpeg2.ts")
# MPEG-1/2, small: cv2's mpg1 and MPEG writers into each container; an
# M2TS with BT.709; a VOB-like PAL program stream; a TS cut mid-GOP
MPEG2_SMALL_FIXTURES = ("mpeg1_cv2.mpg", "mpeg2_cv2.mpg", "mpeg2_cv2.avi",
                        "mpeg2_cv2.mkv", "mpeg2_cv2.mp4", "mpeg1_cv2.mov",
                        "mpeg2_bt709.m2ts", "mpeg2_pal.vob", "mpeg2_cut.ts")
# MPEG-2 4:2:2: a small interlaced-coded transport stream and two FHD
# pictures of the headline scene
MPEG2_422_FIXTURES = ("mpeg2_422.ts", "mpeg2_422_fhd.m2v")


def mpeg2_frames(path: str, timed: bool = False):
    """Every frame the port gives for the MPEG-1/2 video at ``path`` in
    display order, decoded on one thread → (RGB frames, Y planes as cv2
    reads them, decoder statistics, ms per decoded picture or None)."""
    from slam_indoor_code_tpu_torch.io import avi, mpeg12

    video = avi.open_video(path)
    data = [video.read(fr) for fr in video.frames]
    dec = mpeg12.Decoder(video.extradata, video.width, video.height)
    video.close()
    rgb, luma = [], []

    def keep(planes):
        if planes is not None:
            rgb.append(dec.rgb())
            luma.append(planes[0])

    t = time.perf_counter()
    for i, d in enumerate(data):
        keep(dec.decode_yuv(d, i))
        if dec.failed:
            fail(f"mpeg2: {os.path.basename(path)}: picture {i} fails")
    keep(dec.flush_yuv())
    ms = 1e3 * (time.perf_counter() - t) / len(data) if timed else None
    stats = dec.stats()
    dec.close()
    if stats["matrix_coefficients"] == 1:     # cv2 reads Y through RGB
        luma = [mpeg12.luma_read(f) for f in rgb]
    return rgb, luma, stats, ms


def mpeg2_phase(card_line: str, scene, cli):
    """The committed fixtures (the card has no encoder and no cv2): the
    headline transport stream demuxed and timed; every picture decoded on
    one thread, timed, and held to the committed sha256 of cv2's RGB frames
    and Y planes, with the decoder's statistics showing its tools; the
    small MPEG-1/2 fixtures and the 4:2:2 ones held to theirs; ``MediaSource``'s frames equal
    to the decoder's; then the CLI on the .ts with
    ``usePhotosCycle=false`` (``cli``: fixture_clis) → (counts, decode ms
    per frame, tracking ms per frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import mpegts
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    fixtures = os.path.dirname(MPEG2_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(MPEG2_FIXTURE)]
    t = time.perf_counter()
    video = mpegts.open_video(MPEG2_FIXTURE)
    demux_ms = 1e3 * (time.perf_counter() - t)
    n_pictures, codec = len(video.frames), video.codec
    video.close()
    if codec != "mpeg12" or n_pictures != table["frames"]:
        fail(f"mpeg2: the fixture demuxes to {n_pictures} {codec} pictures")
    rgb, luma, stats, decode_ms = mpeg2_frames(MPEG2_FIXTURE, timed=True)
    if ([sha(f) for f in rgb] != table["rgb_sha256"]
            or rgb[0].shape != tuple(table["shape"])):
        fail("mpeg2: the decoded RGB frames differ from cv2's (sha256)")
    if [sha(y) for y in luma] != table["y_sha256"]:
        fail("mpeg2: the Y planes differ from cv2's Y read (sha256)")
    if not (stats["b_pictures"] >= 16 and stats["field_dct_mbs"] > 0
            and stats["field_mc_mbs"] > 0 and stats["alternate_scan"] == 32
            and stats["intra_vlc"] == 32 and stats["non_linear_quant"] == 32
            and stats["max_dc_precision"] == 2
            and stats["matrix_coefficients"] == 1):
        fail(f"mpeg2: the fixture does not use its tools: {stats}")
    for name in MPEG2_SMALL_FIXTURES:
        path = os.path.join(fixtures, name)
        want = tables[name]
        got = [sha(f) for f in MediaSource(video_path=path, use_photos=False)]
        _, small_luma, _, _ = mpeg2_frames(path)
        if got != want["rgb_sha256"] or [sha(y) for y in small_luma
                                         ] != want["y_sha256"]:
            fail(f"mpeg2: the small fixture {name} differs from cv2's decode "
                 f"(sha256)")
    for name in MPEG2_422_FIXTURES:
        path = os.path.join(fixtures, name)
        want = tables[name]
        got = [sha(f) for f in MediaSource(video_path=path, use_photos=False)]
        _, luma422, stats422, _ = mpeg2_frames(path)
        if (got != want["rgb_sha256"]
                or [sha(y) for y in luma422] != want["y_sha256"]
                or stats422["chroma_422_frames"] != want["frames"]
                or not stats422["field_dct_mbs"]):
            fail(f"mpeg2: the 4:2:2 fixture {name} differs from cv2's "
                 f"decode (sha256) or its tools: {stats422}")
    from_ts = list(MediaSource(video_path=MPEG2_FIXTURE, use_photos=False))
    if len(from_ts) != len(rgb) or not all(
            np.array_equal(a, b) for a, b in zip(from_ts, rgb)):
        fail("mpeg2: MediaSource's frames differ from the decoder's")
    n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"mpeg2: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(MPEG2_FIXTURE) / 1e6:.2f} MB transport stream, "
          f"MPEG-2 {stats['b_pictures']} B pictures, "
          f"{stats['field_dct_mbs']} field-DCT and {stats['field_mc_mbs']} "
          f"field-predicted macroblocks, BT.709) equal to cv2's decode "
          f"(sha256 of RGB and Y; the {len(MPEG2_SMALL_FIXTURES)} small "
          f"fixtures' and the {len(MPEG2_422_FIXTURES)} 4:2:2 ones' too, "
          f"FHD among them); cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  launches {json.dumps(n)}  demux "
          f"{demux_ms:.3f} ms; decode {decode_ms:.3f} ms per FHD frame on "
          f"one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms, track_ms


H263_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                            "headline_h263p.3gp")
# H.263, small: cv2's H263 writer into each container; a 4CIF baseline
# stream with 4MV, OBMC and GOB headers; a raw H.263+ stream with every
# annex at quantiser 2; a U263 AVI
H263_SMALL_FIXTURES = ("h263_cv2.avi", "h263_cv2.3gp", "h263_cv2.3g2",
                       "h263_cv2.mov", "h263_cv2.mkv", "h263_4cif_obmc.avi",
                       "h263p_annexes.h263", "h263p_u263.avi")
# the decoder's counts that show each annex of the headline in use: the
# pictures coded with each mode of OPPTYPE, and what each mode did
H263_MODES = ("umv_pictures", "obmc_pictures", "aic_pictures",
              "loop_filter_pictures", "slice_pictures", "aiv_pictures",
              "mq_pictures")
H263_TOOLS = ("umv_codes", "long_vectors", "umv_outside", "inter4v_mbs",
              "obmc_mbs", "aic_blocks", "deblocked_edges", "slice_headers",
              "alt_vlc_blocks", "mq_chroma_mbs", "no_rounding_pictures")


def h263_frames(path: str, timed: bool = False, sorenson: bool = False):
    """Every frame the port gives for the H.263 (``sorenson``: Sorenson
    Spark) video at ``path``, decoded on one thread → (RGB frames, Y
    planes, decoder statistics, ms per picture or None)."""
    from slam_indoor_code_tpu_torch.io import avi, h263

    video = avi.open_video(path)
    data = [video.read(fr) for fr in video.frames]
    dec = h263.Decoder(sorenson=sorenson)
    video.close()
    rgb, luma = [], []
    t = time.perf_counter()
    for i, d in enumerate(data):
        planes = dec.decode_yuv(d)
        if dec.failed:
            fail(f"h263: {os.path.basename(path)}: picture {i} fails")
        rgb.append(dec.rgb())
        luma.append(planes[0])
    ms = 1e3 * (time.perf_counter() - t) / len(data) if timed else None
    stats = dec.stats()
    dec.close()
    return rgb, luma, stats, ms


def h263_phase(card_line: str, scene, cli):
    """The committed fixtures (the card has no encoder and no cv2): the
    headline 3GP demuxed and timed; every picture decoded on one thread,
    timed, and held to the committed sha256 of cv2's RGB frames and Y
    planes, with the decoder's counts showing each annex in use; the small
    H.263 fixtures held to theirs; ``MediaSource``'s frames equal to the
    decoder's; then the CLI on the .3gp with ``usePhotosCycle=false``
    (``cli``: fixture_clis) → (counts, decode ms per frame, tracking ms per
    frame)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    fixtures = os.path.dirname(H263_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(H263_FIXTURE)]
    t = time.perf_counter()
    video = avi.open_video(H263_FIXTURE)
    demux_ms = 1e3 * (time.perf_counter() - t)
    n_pictures, codec = len(video.frames), video.codec
    video.close()
    if codec != "h263" or n_pictures != table["frames"]:
        fail(f"h263: the fixture demuxes to {n_pictures} {codec} pictures")
    rgb, luma, stats, decode_ms = h263_frames(H263_FIXTURE, timed=True)
    if ([sha(f) for f in rgb] != table["rgb_sha256"]
            or rgb[0].shape != tuple(table["shape"])):
        fail("h263: the decoded RGB frames differ from cv2's (sha256)")
    if [sha(y) for y in luma] != table["y_sha256"]:
        fail("h263: the Y planes differ from cv2's Y read (sha256)")
    if not (all(stats[k] == N_FRAMES for k in H263_MODES)
            and all(stats[k] > 0 for k in H263_TOOLS)
            and stats["custom_format"] == N_FRAMES):
        fail(f"h263: the fixture does not use its annexes: {stats}")
    for name in H263_SMALL_FIXTURES:
        path = os.path.join(fixtures, name)
        want = tables[name]
        got = [sha(f) for f in MediaSource(video_path=path, use_photos=False)]
        _, small_luma, _, _ = h263_frames(path)
        if got != want["rgb_sha256"] or [sha(y) for y in small_luma
                                         ] != want["y_sha256"]:
            fail(f"h263: the small fixture {name} differs from cv2's decode "
                 f"(sha256)")
    from_3gp = list(MediaSource(video_path=H263_FIXTURE, use_photos=False))
    if len(from_3gp) != len(rgb) or not all(
            np.array_equal(a, b) for a, b in zip(from_3gp, rgb)):
        fail("h263: MediaSource's frames differ from the decoder's")
    n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"h263: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(H263_FIXTURE) / 1e6:.2f} MB 3GP, H.263+ "
          f"1920x1080 custom format, annexes D F I J K S T: "
          f"{stats['umv_codes']} reversible vector codes, "
          f"{stats['inter4v_mbs']} 4MV and {stats['obmc_mbs']} OBMC "
          f"macroblocks, {stats['aic_blocks']} advanced-intra blocks, "
          f"{stats['deblocked_edges']} deblocked edges, "
          f"{stats['slice_headers']} slice headers, "
          f"{stats['alt_vlc_blocks']} alternative-VLC blocks, "
          f"{stats['mq_chroma_mbs']} macroblocks on Annex T's chroma "
          f"quantiser) equal to cv2's decode (sha256 of RGB and Y; the "
          f"{len(H263_SMALL_FIXTURES)} small fixtures' too); cameras "
          f"{n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of extent  launches "
          f"{json.dumps(n)}  demux {demux_ms:.3f} ms; decode "
          f"{decode_ms:.3f} ms per FHD frame on one thread; tracking "
          f"{track_ms:.3f} ms per frame; CLI run {run_s:.3f} s ({when})  "
          f"[{card_line}]", flush=True)
    return n, decode_ms, track_ms


FLV_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                           "headline_flv1.flv")
# Sorenson Spark, small: cv2's FLV1 writer into .flv, .avi, .mkv and .mov;
# libavcodec's flv encoder at quantiser 1 (FLV's 11-bit escapes) with audio
# and script tags between the pictures
FLV_SMALL_FIXTURES = ("flv1_cv2.flv", "flv1_cv2.avi", "flv1_cv2.mkv",
                      "flv1_cv2.mov", "flv1_q1_audio_script.flv")
# PNG as video, small: cv2's MPNG writer into .avi and .mkv, its png writer
# into .mov
MPNG_SMALL_FIXTURES = ("mpng_cv2.avi", "mpng_cv2.mkv", "png_cv2.mov")


def video_sha(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def flv_phase(card_line: str, scene, cli):
    """The committed FLV fixtures (the card has no encoder and no cv2): the
    headline .flv demuxed and timed; every Sorenson picture decoded on one
    thread, timed, and held to the committed sha256 of cv2's RGB frames
    and Y planes, with FLV's 7-bit escapes in use; the small fixtures held
    to theirs, the quantiser-1 one using 11-bit escapes; ``MediaSource``'s
    frames equal to the decoder's; then the CLI on the .flv (``cli``:
    fixture_clis) → (counts, decode ms per frame, tracking ms per
    frame)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    fixtures = os.path.dirname(FLV_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(FLV_FIXTURE)]
    t = time.perf_counter()
    video = avi.open_video(FLV_FIXTURE)
    demux_ms = 1e3 * (time.perf_counter() - t)
    n_pictures, codec = len(video.frames), video.codec
    video.close()
    if codec != "flv1" or n_pictures != table["frames"]:
        fail(f"flv: the fixture demuxes to {n_pictures} {codec} pictures")
    rgb, luma, stats, decode_ms = h263_frames(FLV_FIXTURE, timed=True,
                                              sorenson=True)
    if ([video_sha(f) for f in rgb] != table["rgb_sha256"]
            or rgb[0].shape != tuple(table["shape"])):
        fail("flv: the decoded RGB frames differ from cv2's (sha256)")
    if [video_sha(y) for y in luma] != table["y_sha256"]:
        fail("flv: the Y planes differ from cv2's Y read (sha256)")
    if stats["sorenson_pictures"] != N_FRAMES or not stats["flv_escapes_7"]:
        fail(f"flv: the fixture's counts: {stats}")
    escapes_11 = 0
    for name in FLV_SMALL_FIXTURES:
        path = os.path.join(fixtures, name)
        want = tables[name]
        got = [video_sha(f) for f in MediaSource(video_path=path,
                                                 use_photos=False)]
        _, small_luma, small, _ = h263_frames(path, sorenson=True)
        escapes_11 += small["flv_escapes_11"]
        if got != want["rgb_sha256"] or [video_sha(y) for y in small_luma
                                         ] != want["y_sha256"]:
            fail(f"flv: the small fixture {name} differs from cv2's decode "
                 f"(sha256)")
    if not escapes_11:
        fail("flv: no small fixture used FLV's 11-bit escape")
    from_flv = list(MediaSource(video_path=FLV_FIXTURE, use_photos=False))
    if len(from_flv) != len(rgb) or not all(
            np.array_equal(a, b) for a, b in zip(from_flv, rgb)):
        fail("flv: MediaSource's frames differ from the decoder's")
    n, n_cams, ate_pct, _, run_s, when = cli
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"flv: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(FLV_FIXTURE) / 1e6:.2f} MB FLV, Sorenson "
          f"Spark 1920x1080 at quantiser 6: {stats['flv_escapes_7']} 7-bit "
          f"escapes, {stats['flv_escapes_11']} 11-bit; the small "
          f"quantiser-1 fixture's {escapes_11} 11-bit) equal to cv2's "
          f"decode (sha256 of RGB and Y; the {len(FLV_SMALL_FIXTURES)} "
          f"small fixtures' too); cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  launches {json.dumps(n)}  demux "
          f"{demux_ms:.3f} ms; decode {decode_ms:.3f} ms per FHD frame on "
          f"one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms, track_ms


def mpng_video(frames, root: str) -> str:
    """The frames as the cli phase writes them (io/png.py's write_png, the
    same bytes), muxed on the card into one MPNG AVI under ``root`` by
    testing/mjpeg.py's write_avi → its path."""
    from slam_indoor_code_tpu_torch.io.png import write_png
    from slam_indoor_code_tpu_torch.testing import mjpeg

    pngs = []
    for i, f in enumerate(frames):
        p = os.path.join(root, f"frame_{i}.png")
        write_png(p, f)
        with open(p, "rb") as fh:
            pngs.append(fh.read())
        os.remove(p)
    path = os.path.join(root, "frames_mpng.avi")
    h, w = frames[0].shape[:2]
    mjpeg.write_avi(path, pngs, w, h, fourcc=b"MPNG")
    return path


def mpng_phase(card_line: str, frames, path: str, cli, cli_counts,
               cli_poses):
    """The MPNG AVI of the cli phase's PNGs (mpng_video): demuxed and
    timed, every frame decoded by io/png.py on one thread, timed, equal to
    the rendered frame; the small cv2-written MPNG and ``png `` fixtures
    held to cv2's sha256; the CLI on the AVI (``cli``: fixture_clis):
    poses.txt equal to the cli phase's byte for byte, its ``top2_batch``
    launches → (counts, decode ms per frame, tracking ms per frame)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    t = time.perf_counter()
    video = avi.open_video(path)
    demux_ms = 1e3 * (time.perf_counter() - t)
    if video.codec != "png" or len(video.frames) != len(frames):
        fail(f"mpng: the AVI demuxes to {len(video.frames)} "
             f"{video.codec} frames")
    t = time.perf_counter()
    decoded = [video.decode_frame(fr) for fr in video.frames]
    decode_ms = 1e3 * (time.perf_counter() - t) / len(frames)
    video.close()
    if not all(d is not None and np.array_equal(d, f)
               for d, f in zip(decoded, frames)):
        fail("mpng: a decoded frame differs from the rendered one")
    del decoded
    fixtures = os.path.dirname(FLV_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    for name in MPNG_SMALL_FIXTURES:
        got = [video_sha(f) for f in MediaSource(
            video_path=os.path.join(fixtures, name), use_photos=False)]
        if got != tables[name]["rgb_sha256"]:
            fail(f"mpng: the small fixture {name} differs from cv2's "
                 "decode (sha256)")
    n, n_cams, ate_pct, poses, run_s, when = cli
    if poses != cli_poses:
        fail("mpng: poses.txt differs from the cli phase's")
    if n["top2_batch"] != cli_counts["top2_batch"]:
        fail(f"mpng: {n['top2_batch']} top2_batch launches, the cli "
             f"phase's {cli_counts['top2_batch']}")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    print(f"mpng: exit 0, {len(frames)} PNG frames "
          f"({os.path.getsize(path) / 1e6:.2f} MB MPNG AVI muxed on the "
          f"card) decode to the rendered frames; the "
          f"{len(MPNG_SMALL_FIXTURES)} small MPNG/png fixtures equal cv2's "
          f"decode (sha256); cameras {n_cams}/{N_FRAMES}  ATE "
          f"{ate_pct:.4f}% of extent  poses.txt equals the cli phase's "
          f"byte for byte  launches {json.dumps(n)}  demux "
          f"{demux_ms:.3f} ms; decode {decode_ms:.3f} ms per FHD frame on "
          f"one thread; tracking {track_ms:.3f} ms per frame; CLI run "
          f"{run_s:.3f} s ({when})  [{card_line}]", flush=True)
    return n, decode_ms, track_ms


FFV1_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                            "headline_ffv1.mkv")
# FFV1 and HuffYUV, small: cv2's FFV1 writer into AVI and QuickTime;
# libavcodec's FFV1 level 3 at 4:2:0 with slice CRCs and a custom state
# table, and level 1 Golomb-Rice with the large context model; cv2's HFYU
# writer into AVI and Matroska and its FFVH writer into AVI; huffyuv 4:2:2
# with median prediction; FFVHuff with tables in every frame.  And the
# headline's first frame through cv2's FFVH writer (FHD, timed).
LOSSLESS_SMALL_FIXTURES = ("ffv1_cv2.avi", "ffv1_cv2.mov",
                           "ffv1_l3_crc_coder2.avi", "ffv1_golomb.avi",
                           "hfyu_cv2.avi", "hfyu_cv2.mkv", "ffvh_cv2.avi",
                           "huffyuv_422_median.avi", "ffvh_context.avi")
FFVH_FHD_FIXTURE = os.path.join(os.path.dirname(MP4_FIXTURE),
                                "ffvh_fhd_cv2.avi")


def fixture_clis(scene, mpng_path: str, photos_pattern: str,
                 jpegs: dict) -> tuple:
    """The CLI on each committed headline video (``usePhotosCycle=false``)
    and photo glob, one run after another in one subprocess
    (cli_counted_many's checks on each), which pays the interpreter's,
    PyTorch's and the card's start once: the lossless phase's first, so
    that its run is a cold one as in a user's ``python -m``; then the
    jpeg, video, progjpeg, tiffjpeg and damaged phases' (``jpegs``:
    jpeg_files'),
    the jp2 phase's fixture glob, the mp4, asp (its two runs: the packed
    fixture, "asp", and the interlaced one, "asp-il"), webm, vp9, mpeg2,
    h263 and flv phases', the mpng phase's AVI (``mpng_path``) and the
    photos phase's glob (``photos_pattern``); then the lossless run again,
    warm, which measures what the shared process saves → ({phase: (counts,
    cameras, ATE %, poses.txt, run s, "run k of n in one process,
    cold|warm")}, the subprocess's s, the decoders' build s); the warm
    repeat is "lossless-warm"."""
    from concurrent.futures import ThreadPoolExecutor

    from slam_indoor_code_tpu_torch.io import (ffv1, gif, h263, huffyuv,
                                               jp2, jpeg, mpeg4, mpeg12, png,
                                               tiff, vp8, vp9, webp)

    globs = {"jpeg": jpegs["jpeg"], "progjpeg": jpegs["prog_pattern"],
             "tiffjpeg": jpegs["tiff_pattern"], "damaged": jpegs["damaged"],
             "jp2": os.path.join(JP2_FIXTURES, "frame_*.jp2"),
             "photos": photos_pattern}
    videos = {"lossless": FFV1_FIXTURE, "jpeg": None,
              "video": jpegs["avi"], "progjpeg": None, "tiffjpeg": None,
              "damaged": None, "jp2": None, "mp4": MP4_FIXTURE,
              "asp": ASP_FIXTURE, "asp-il": ASP_IL_FIXTURE,
              "webm": WEBM_FIXTURE, "vp9": VP9_FIXTURE,
              "mpeg2": MPEG2_FIXTURE, "h263": H263_FIXTURE,
              "flv": FLV_FIXTURE, "mpng": mpng_path, "photos": None,
              "lossless-warm": FFV1_FIXTURE}
    # the runs' decoders built first, in parallel, as a user's runs after
    # the first find them: no run pays a g++ build inside its slam_main
    t = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda m: m.load(),
                      (ffv1, gif, h263, huffyuv, jp2, jpeg, mpeg4, mpeg12,
                       png, tiff, vp8, vp9, webp)))
    build_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as top:
        jobs = []
        for what, path in videos.items():
            root = os.path.join(top, what)
            os.makedirs(root)
            cfg = headline_config(os.path.join(root, "out"))
            cfg = (dataclasses.replace(cfg, photosPathPattern=globs[what])
                   if path is None else dataclasses.replace(
                       cfg, usePhotosCycle=False, videoSourcePath=path))
            jobs.append((what, cfg, root, ()))
        runs, run_s = cli_counted_many(jobs, scene)
    runs = {what: (*run, f"run {k + 1} of {len(runs)} in one process, "
                   f"{'warm' if k else 'cold'}")
            for k, (what, run) in enumerate(zip(videos, runs))}
    return runs, run_s, build_s


def lossless_frames(path: str, timed: bool = False):
    """Every frame the port gives for the FFV1 or HuffYUV video at
    ``path``, decoded on one thread → (RGB frames, decoder statistics, ms
    per frame or None)."""
    from slam_indoor_code_tpu_torch.io import avi, ffv1, huffyuv

    video = avi.open_video(path)
    data = [video.read(fr) for fr in video.frames]
    dec = (ffv1.Decoder(video.extradata, video.width, video.height)
           if video.codec == "ffv1" else
           huffyuv.Decoder(video.extradata, video.width, video.height,
                           video.bits_per_coded_sample))
    video.close()
    rgb = []
    t = time.perf_counter()
    for i, d in enumerate(data):
        rgb.append(dec.decode(d))
        if dec.failed:
            fail(f"lossless: {os.path.basename(path)}: frame {i} fails "
                 f"({dec.reason})")
    ms = 1e3 * (time.perf_counter() - t) / len(data) if timed else None
    stats = dec.stats()
    dec.close()
    return rgb, stats, ms


def lossless_phase(card_line: str, frames, logged_l2, cli, warm):
    """The committed fixtures (the card has no encoder and no cv2): the
    headline FFV1 .mkv (the 32 rendered frames through cv2's own ``FFV1``
    writer) demuxed and timed; every frame decoded on one thread, timed,
    equal to the rendered frames (FFV1 in RGB is lossless) and to the
    committed sha256 of cv2's decode; the small FFV1 and HuffYUV fixtures
    held to theirs through ``MediaSource``, and the FHD FFVH frame decoded
    on one thread and timed; ``MediaSource``'s frames equal to the
    decoder's; then the CLI run on the .mkv (``cli``: fixture_clis, the
    first run of its process: cold), whose poses.txt must equal phase 4's
    byte for byte (the same frames, K and seed), and the same run repeated
    last in that process (``warm``), whose poses.txt and launches must
    equal the cold run's → (counts, FFV1 and HuffYUV decode ms per FHD
    frame, tracking ms per frame cold and warm)."""
    import hashlib

    import numpy as np

    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.io.media import MediaSource

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    fixtures = os.path.dirname(FFV1_FIXTURE)
    with open(os.path.join(fixtures, "cv2_sha256.json")) as f:
        tables = json.load(f)
    table = tables[os.path.basename(FFV1_FIXTURE)]
    t = time.perf_counter()
    video = avi.open_video(FFV1_FIXTURE)
    demux_ms = 1e3 * (time.perf_counter() - t)
    n_packets, codec = len(video.frames), video.codec
    video.close()
    if codec != "ffv1" or n_packets != N_FRAMES or table["frames"] != N_FRAMES:
        fail(f"lossless: the fixture demuxes to {n_packets} {codec} frames")
    rgb, stats, ffv1_ms = lossless_frames(FFV1_FIXTURE, timed=True)
    if [sha(f) for f in rgb] != table["rgb_sha256"]:
        fail("lossless: the decoded frames differ from cv2's (sha256)")
    if len(rgb) != len(frames) or not all(
            np.array_equal(a, b) for a, b in zip(rgb, frames)):
        fail("lossless: the decoded frames differ from the rendered ones")
    if (stats["version"], stats["colorspace"], stats["transparency"],
            stats["key_frames"]) != (3, 1, 1, 3) or not (
            stats["crc_slices"] == stats["slices"] >= 4 * N_FRAMES
            and stats["golomb_slices"] == stats["slices"]
            and stats["damaged_slices"] == 0):
        fail(f"lossless: the fixture is not what cv2's writer writes: "
             f"{stats}")
    for name in LOSSLESS_SMALL_FIXTURES:
        got = [sha(f) for f in MediaSource(
            video_path=os.path.join(fixtures, name), use_photos=False)]
        if got != tables[name]["rgb_sha256"]:
            fail(f"lossless: the small fixture {name} differs from cv2's "
                 "decode (sha256)")
    fhd, hstats, hyuv_ms = lossless_frames(FFVH_FHD_FIXTURE, timed=True)
    if [sha(f) for f in fhd] != tables[os.path.basename(
            FFVH_FHD_FIXTURE)]["rgb_sha256"] or hstats["bitstream_bpp"] != 12:
        fail("lossless: the FHD FFVH frame differs from cv2's decode "
             f"(sha256) or is not 4:2:0: {hstats}")
    from_mkv = list(MediaSource(video_path=FFV1_FIXTURE, use_photos=False))
    if len(from_mkv) != len(rgb) or not all(
            np.array_equal(a, b) for a, b in zip(from_mkv, rgb)):
        fail("lossless: MediaSource's frames differ from the decoder's")
    n, n_cams, ate_pct, poses, run_s, when = cli
    if poses != logged_l2["poses"]:
        fail("lossless: poses.txt differs from the main path's")
    n_warm, _, _, poses_warm, run_warm_s, when_warm = warm
    if poses_warm != poses or n_warm["top2_batch"] != n["top2_batch"]:
        fail("lossless: the warm repeat's poses.txt or launches differ from "
             "the cold run's")
    track_ms = 1e3 * n["slam_main_s"] / N_FRAMES
    warm_ms = 1e3 * n_warm["slam_main_s"] / N_FRAMES
    print(f"lossless: exit 0, {len(rgb)} frames "
          f"({os.path.getsize(FFV1_FIXTURE) / 1e6:.2f} MB Matroska, FFV1 "
          f"version 3 from cv2's writer: BGRA, {stats['slices']} Golomb-"
          f"Rice slices with CRCs, {stats['key_frames']} key frames, "
          f"{stats['runs']} runs over {stats['run_pixels']} pixels) equal "
          f"to the rendered frames and to cv2's decode (sha256; the "
          f"{len(LOSSLESS_SMALL_FIXTURES)} small FFV1 and HuffYUV fixtures' "
          f"too); cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent  poses.txt equals the main path's byte for byte  "
          f"launches {json.dumps(n)}  demux {demux_ms:.3f} ms; decode "
          f"{ffv1_ms:.3f} ms per FHD frame (FFV1) and {hyuv_ms:.3f} ms "
          f"(FFVHuff 4:2:0, {hstats['frames']} frame) on one thread; "
          f"tracking {track_ms:.3f} ms per frame; CLI run {run_s:.3f} s "
          f"({when}); the same run repeated: tracking {warm_ms:.3f} ms per "
          f"frame, CLI run {run_warm_s:.3f} s ({when_warm}), poses.txt "
          f"equal; what the shared process warms: "
          f"{n['slam_main_s'] - n_warm['slam_main_s']:.3f} s of slam_main  "
          f"[{card_line}]", flush=True)
    return n, ffv1_ms, hyuv_ms, track_ms, warm_ms


# The real-texture scene at FHD: 24 frames (the JAX package's default
# sweep, 0.12 per frame), two procedural textures from seeds, rendered on
# the card.  The good-frame rule keeps the head-most best-matched frame of
# each batch, which on this sweep is every other frame: the JAX package
# keeps 13 of the 24 on the CPU (frames 0, 2, ..., 22, 23), as the port
# does there.
N_FRAMES_RT = 24
MIN_CAMERAS_RT = 12


def realtex_scene():
    """testing/realtex.py's two-plane scene at 1080x1920, N_FRAMES_RT
    frames, over two procedural textures (seeds 21 and 22)."""
    from slam_indoor_code_tpu_torch.testing import realtex

    far = realtex.procedural_texture((1080, 1920), 21)
    near = realtex.procedural_texture((1080, 1125), 22)
    return realtex.make_two_plane_scene([far, near], n_frames=N_FRAMES_RT,
                                        step=0.12, image_size=(1080, 1920))


def realtex_phase(card_line: str):
    """testing/realtex.py's two-plane scene at 1080x1920 with two
    procedural textures (posterized multi-octave noise, seeds 21 and 22;
    no photo), rendered on the card (frame 0 must equal its CPU render bit
    for bit), then ``slam_main`` on CUDA with the headline configuration:
    cameras >= 12/24 at ATE < 5 % of extent against the scene's exact
    centres, one L2 ``top2_batch`` launch per scan step and bootstrap
    match → counts."""
    import numpy as np
    import torch

    scene = realtex_scene()
    scene.render(0, device="cuda")            # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = [scene.render(i, device="cuda") for i in range(N_FRAMES_RT)]
    render_ms = 1e3 * (time.perf_counter() - t) / N_FRAMES_RT
    if not np.array_equal(frames[0], scene.render(0, device="cpu")):
        fail("realtex: the card's render differs from the CPU's")
    what = "realtex"
    with tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, logged = slam_run(headline_config(out), scene,
                                               frames)
    n_cams, ate_pct = trajectory_ok(what, scene, gd, N_FRAMES_RT,
                                    MIN_CAMERAS_RT)
    on_cuda(what, engine)
    steps = len(logged["picks"])
    if (n["top2_batch"] != steps + engine.match_select_calls or steps == 0
            or n["hamming"] or n["lpb"] or n["top2_pair"] or n["top2_l1"]):
        fail(f"{what}: launches {n} for {steps} scan steps and "
             f"{engine.match_select_calls} bootstrap matches")
    report(what, n_cams, ate_pct, gd, wall, n, card_line, N_FRAMES_RT)
    print(f"realtex: render {render_ms:.3f} ms per frame on the card (two "
          f"planes, 1080x1920, equal to the CPU render)  [{card_line}]",
          flush=True)
    return n


# ------------------------------------------------------- distribution slice

def sync_time(fn):
    """(fn(), seconds) with the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def board_views(K, n_views: int, seed: int = 3):
    """``n_views`` views of the 7x7 chessboard through K with distortion
    (0.08, -0.15, 0.001, -0.0005, 0) and 0.1 px noise, from a seed."""
    import numpy as np

    from slam_indoor_code_tpu_torch.calibration import make_object_points

    rng = np.random.default_rng(seed)
    obj = make_object_points()
    k1, k2, p1, p2, k3 = 0.08, -0.15, 0.001, -0.0005, 0.0
    views = []
    for _ in range(n_views):
        aa = rng.normal(0, 0.3, 3)
        th = np.linalg.norm(aa)
        k = aa / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(400, 700)])
        Xc = obj @ R.T + t
        x, y = Xc[:, 0] / Xc[:, 2], Xc[:, 1] / Xc[:, 2]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        uv = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], 1)
        views.append(uv + rng.normal(0, 0.1, uv.shape))
    return obj, views


def calibrate_phase(card_line: str, scene):
    """``calibrate_camera`` on CUDA over 20 synthetic views of the board
    through the headline's FHD K: fx and fy within 1 %, rms < 0.3 px, K
    within 2e-3 relative of the port's CPU result on the same views; the
    XML written and reloaded."""
    import numpy as np

    from slam_indoor_code_tpu_torch.calibration import calibrate_camera
    from slam_indoor_code_tpu_torch.io.xmlio import (
        load_matrix_from_xml, save_calib_parameters_to_xml)

    obj, views = board_views(scene.K, 20)
    (K, dist, rvecs, tvecs, rms), secs = sync_time(
        lambda: calibrate_camera(obj, views, device="cuda"))
    t = time.perf_counter()
    Kc, _, _, _, rms_c = calibrate_camera(obj, views, device="cpu")
    cpu_s = time.perf_counter() - t
    for i, name in ((0, "fx"), (1, "fy")):
        err = abs(K[i, i] - scene.K[i, i]) / scene.K[i, i]
        if not err < 0.01:
            fail(f"calibrate: {name} {K[i, i]:.3f} is {100 * err:.3f}% from "
                 f"the truth {scene.K[i, i]:.3f}")
    if not rms < 0.3:
        fail(f"calibrate: rms {rms:.4f} px >= 0.3")
    rel = float(np.abs(K - Kc).max() / np.abs(Kc).max())
    if not rel < 2e-3:
        fail(f"calibrate: K on the card is {rel:.3g} (relative) from the "
             "CPU's")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cam.xml")
        save_calib_parameters_to_xml(path, K, dist.reshape(1, 5), rvecs,
                                     tvecs)
        if not (np.allclose(load_matrix_from_xml(path, "K"), K, atol=1e-6)
                and load_matrix_from_xml(path, "R").shape == (20, 3)):
            fail("calibrate: the XML does not reload K and the 20 views")
    print(f"calibrate: 20 views at FHD, fx {K[0, 0]:.4f} fy {K[1, 1]:.4f} "
          f"(truth {scene.K[0, 0]:.1f}), cx {K[0, 2]:.4f} cy {K[1, 2]:.4f}, "
          f"k1 {dist[0]:.5f} k2 {dist[1]:.5f}, rms {rms:.5f} px (CPU "
          f"{rms_c:.5f}); K vs CPU max rel {rel:.3g}; solve {secs:.4f} s on "
          f"the card, {cpu_s:.4f} s on the CPU ({os.cpu_count()} cores); XML "
          f"reloaded  [{card_line}]", flush=True)
    return secs


# ``python -m slam_indoor_code_tpu_torch`` with ``calibrate`` through runpy,
# once per configuration given, in one process, reporting for each run its
# corner detections' host seconds and whether each found a board, and the
# solve's seconds (card synchronised), rms and view count.
CLI_CALIBRATE = r"""
import json, runpy, sys, time
import torch
from slam_indoor_code_tpu_torch.calibration import chessboard as cb
seen = {}
find, solve = cb.find_chessboard_corners, cb.calibrate_camera
def timed_find(*a, **kw):
    t = time.perf_counter()
    c = find(*a, **kw)
    seen["detect_s"].append(time.perf_counter() - t)
    seen["found"].append(c is not None)
    return c
def timed_solve(obj, pts, *a, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = solve(obj, pts, *a, **kw)
    torch.cuda.synchronize()
    seen["solve_s"].append(time.perf_counter() - t)
    seen["rms"].append(out[4])
    seen["views"].append(len(pts))
    return out
cb.find_chessboard_corners, cb.calibrate_camera = timed_find, timed_solve
for cfg in sys.argv[1:]:
    seen.update(detect_s=[], found=[], solve_s=[], rms=[], views=[])
    sys.argv = ["slam_indoor_code_tpu_torch", cfg]
    try:
        runpy.run_module("slam_indoor_code_tpu_torch", run_name="__main__",
                         alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code
    print("calib: " + json.dumps(seen), flush=True)
    if code:
        sys.exit(code)
"""

# The views of the calibration from pixels (cut from 20: each view costs
# a render, a host detection, a PNG, a numpy JPEG encode of ~1.3 s and two
# detections in the CLI; 12 still put fx/fy well inside 1 %).
BOARD_VIEWS = 12
BOARD_DIST = (0.08, -0.15, 0.001, -0.0005, 0.0)
BOARD_NOISE = 2.0


def rendered_board_views(K, n_views: int, seed: int = 5,
                         size=(1080, 1920)):
    """``n_views`` views of the 7x7 board rendered on the card by
    testing/board.py through K with ``BOARD_DIST`` and noise of
    ``BOARD_NOISE`` gray levels, from a seed: any in-plane angle, tilts of
    σ 0.3 rad, the whole board 40 px inside the frame → (gray u8 views,
    projected corners, render seconds per view)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.testing import board

    rng = np.random.default_rng(seed)
    H, W = size
    dist = np.array(BOARD_DIST)
    views, truth, spent = [], [], 0.0
    while len(views) < n_views:
        R = np.eye(3)
        for aa in (rng.normal(0, 0.3, 3),
                   np.array([0, 0, rng.uniform(-np.pi, np.pi)])):
            th = np.linalg.norm(aa)
            k = aa / th
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                           [-k[1], k[0], 0]])
            R = R @ (np.eye(3) + np.sin(th) * Kx
                     + (1 - np.cos(th)) * Kx @ Kx)
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(420, 700)]) - R @ np.array([60, 60, 0.0])
        # the board's outer squares reach one cell past the inner corners
        outline = board.project_corners(
            K, dist, R, R @ np.array([-20.0, -20.0, 0.0]) + t, (9, 9))
        if (outline.min() < 40 or outline[:, 0].max() > W - 40
                or outline[:, 1].max() > H - 40):
            continue
        (img, secs) = sync_time(lambda: board.render_view(
            K, dist, R, t, size, noise=BOARD_NOISE, seed=len(views),
            device="cuda"))
        spent += secs
        views.append(img)
        truth.append(board.project_corners(K, dist, R, t))
    return views, truth, spent / n_views


def cli_calibrate(runs: dict, root: str) -> dict:
    """The CLI module with ``calibrate`` for each configuration of ``runs``
    (name → Config), one after the other in one subprocess under
    CLI_CALIBRATE: exit 0, each XML's K and BOARD_VIEWS views → name → (K,
    that run's report of detections and solves)."""
    import re

    from slam_indoor_code_tpu_torch.config import dump_config
    from slam_indoor_code_tpu_torch.io.xmlio import load_matrix_from_xml

    repo = os.path.dirname(os.path.abspath(__file__))
    paths = []
    for what, cfg in runs.items():
        paths.append(os.path.join(root, f"{what}.json"))
        with open(paths[-1], "w") as f:
            f.write(dump_config(cfg))
    r = subprocess.run([sys.executable, "-c", CLI_CALIBRATE, *paths],
                       capture_output=True, text=True, timeout=600, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo))
    if r.returncode != 0:
        fail(f"calibrate ({', '.join(runs)}): exit {r.returncode}: "
             f"{r.stderr[-2000:]}")
    reports = re.findall(r"^calib: (.*)$", r.stdout, re.M)
    if len(reports) != len(runs):
        fail(f"calibrate: {len(reports)} reports for {len(runs)} runs in "
             f"{r.stdout[-500:]!r}")
    out = {}
    for (what, cfg), report in zip(runs.items(), reports):
        seen = json.loads(report)
        K = load_matrix_from_xml(cfg.calibrationPath, "K")
        n_views = load_matrix_from_xml(cfg.calibrationPath, "R").shape[0]
        if n_views != BOARD_VIEWS or seen["views"] != [BOARD_VIEWS]:
            fail(f"calibrate ({what}): {n_views} views in the XML, "
                 f"{seen['views']} solved; {BOARD_VIEWS} expected")
        out[what] = (K, seen)
    return out


def hold_k(what: str, K, K_true, size, rms) -> None:
    """fx/fy within 1 % of the truth, cx/cy within 1 % of the image size,
    rms < 0.3 px (not held where ``rms`` is None)."""
    H, W = size
    for i, name in ((0, "fx"), (1, "fy")):
        err = abs(K[i, i] - K_true[i, i]) / K_true[i, i]
        if not err < 0.01:
            fail(f"calibrate ({what}): {name} {K[i, i]:.3f} is "
                 f"{100 * err:.3f}% from the truth {K_true[i, i]:.3f}")
    for i, name, n in ((0, "cx", W), (1, "cy", H)):
        if not abs(K[i, 2] - K_true[i, 2]) < 0.01 * n:
            fail(f"calibrate ({what}): {name} {K[i, 2]:.3f} is more than "
                 f"1% of {n} px from the truth {K_true[i, 2]:.3f}")
    if rms is not None and not rms < 0.3:
        fail(f"calibrate ({what}): rms {rms:.4f} px >= 0.3")


def fax_pages(views, root: str):
    """The board views thresholded at 128 as bilevel CCITT TIFF pages under
    ``root`` (the first half Group 4, the rest Group 3 2D with FillOrder
    2, by the numpy writer), each decoded on one thread by io/photo.py
    and held to its thresholded view bit for bit → (the glob, write ms per
    page, decode ms per page, bytes per page)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io import photo, tiff
    from slam_indoor_code_tpu_torch.testing import photos

    tiff.load_fax()       # built first: the pages' decode is timed alone
    pages, spent = [], 0.0
    for i, img in enumerate(views):
        bits = (np.asarray(img) < 128).astype(np.uint8)
        t = time.perf_counter()
        data = (photos.encode_tiff(bits, compression="group4")
                if i < len(views) // 2 else
                photos.encode_tiff(bits, compression="group3", t4_options=1,
                                   fill_order=2))
        spent += time.perf_counter() - t
        pages.append(data)
        with open(os.path.join(root, f"board_{i:02d}.tif"), "wb") as f:
            f.write(data)
    decoded = 0.0
    for i, (img, data) in enumerate(zip(views, pages)):
        t = time.perf_counter()
        got = photo.decode(data)
        decoded += time.perf_counter() - t
        want = np.where(np.asarray(img) >= 128, 255, 0).astype(np.uint8)
        if got is None or not np.array_equal(
                got, np.repeat(want[..., None], 3, axis=2)):
            fail(f"calibrate (fax): page {i} does not decode to its "
                 "thresholded view")
    n = len(pages)
    return (os.path.join(root, "*.tif"), 1e3 * spent / n, 1e3 * decoded / n,
            sum(map(len, pages)) / n)


def calibrate_pixels(card_line: str, scene, frames):
    """Calibration from pixels through the CLI (the calibrate phase's
    second part)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from slam_indoor_code_tpu_torch.calibration import chessboard as cb
    from slam_indoor_code_tpu_torch.config import Config
    from slam_indoor_code_tpu_torch.io.png import write_png
    from slam_indoor_code_tpu_torch.models.frontend import host_gray
    from slam_indoor_code_tpu_torch.testing import board, mjpeg

    size = (1080, 1920)
    views, truth, render_s = rendered_board_views(scene.K, BOARD_VIEWS)
    # host-side detection, held to the projection
    errs, board_s = [], []
    for img, want in zip(views, truth):
        t = time.perf_counter()
        got = cb.find_chessboard_corners(img.astype(np.float64))
        board_s.append(time.perf_counter() - t)
        if got is None:
            fail(f"calibrate: no board found in view {len(errs)}")
        errs.append(np.linalg.norm(got[:, None] - want[None], axis=2).min(0))
    errs = np.concatenate(errs)
    if not (np.median(errs) < 0.1 and errs.max() < 0.5):
        fail(f"calibrate: corners {np.median(errs):.4f} px (median) / "
             f"{errs.max():.4f} px (max) from the projection")
    t = time.perf_counter()
    empty = cb.find_chessboard_corners(host_gray(frames[0]).astype(
        np.float64))
    empty_s = time.perf_counter() - t
    K = scene.K
    R = np.eye(3)
    cut = board.render_view(K, np.array(BOARD_DIST), R,
                            np.array([200.0, -60.0, 500.0]), size,
                            noise=BOARD_NOISE, device="cuda")
    if empty is not None or cb.find_chessboard_corners(
            cut.astype(np.float64)) is not None:
        fail("calibrate: a board was found in a board-free frame or in a "
             "board cut by the frame edge")

    with tempfile.TemporaryDirectory() as root:
        photos = os.path.join(root, "photos")
        os.makedirs(photos)
        for i, img in enumerate(views):
            write_png(os.path.join(photos, f"board_{i:02d}.png"),
                      np.repeat(img[..., None], 3, axis=2))
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            jpegs = list(pool.map(lambda img: mjpeg.encode_jpeg(
                np.repeat(img[..., None], 3, axis=2)), views))
        avi = os.path.join(root, "board.avi")
        mjpeg.write_avi(avi, [j for j in jpegs for _ in range(10)], size[1],
                        size[0])
        os.makedirs(os.path.join(root, "fax"))
        fax_glob, fax_write_ms, fax_ms, fax_bytes = fax_pages(
            views, os.path.join(root, "fax"))
        runs = cli_calibrate({
            what: Config(calibrate=True, usePhotosCycle=use_photos,
                         photosPathPattern=pattern, videoSourcePath=avi,
                         calibrationPath=os.path.join(root, f"{what}.xml"),
                         outputDataDir=os.path.join(root, "out"))
            for what, use_photos, pattern in (
                ("photos", True, os.path.join(photos, "*.png")),
                ("video", False, ""), ("fax", True, fax_glob))}, root)
        for what, (Kc, seen) in runs.items():
            # bilevel corners are not the grey ones: the fax run's rms is
            # reported, not held
            hold_k(what, Kc, K, size,
                   None if what == "fax" else seen["rms"][0])
            if what == "photos" and sum(seen["found"]) != BOARD_VIEWS:
                fail(f"calibrate (photos): {sum(seen['found'])}/"
                     f"{BOARD_VIEWS} boards found")
    lines = []
    for what, (Kc, seen) in runs.items():
        lines.append(
            f"{what}: fx {Kc[0, 0]:.4f} fy {Kc[1, 1]:.4f} cx {Kc[0, 2]:.4f} "
            f"cy {Kc[1, 2]:.4f} rms {seen['rms'][0]:.5f} px, "
            f"{sum(seen['found'])}/{len(seen['found'])} boards found, "
            f"detection {1e3 * np.mean(seen['detect_s']):.1f} ms per frame "
            f"in the CLI, solve {seen['solve_s'][0]:.4f} s on the card")
    print(f"calibrate (pixels): {BOARD_VIEWS} FHD views rendered on the "
          f"card ({1e3 * render_s:.1f} ms each), corners {np.median(errs):.4f} px "
          f"median / {errs.max():.4f} px max from the projection; detection "
          f"{1e3 * np.mean(board_s):.1f} ms per FHD photo with a board "
          f"(max {1e3 * max(board_s):.1f}), {1e3 * empty_s:.1f} ms without "
          f"(host, numpy); truth fx {K[0, 0]:.1f} cx {K[0, 2]:.1f} cy "
          f"{K[1, 2]:.1f}; CLI {'; '.join(lines)}; fax pages (6 Group 4, 6 "
          f"Group 3 2D FillOrder 2) equal their thresholded views, "
          f"{fax_bytes / 1e3:.1f} kB, written in {fax_write_ms:.1f} ms and "
          f"decoded in {fax_ms:.3f} ms per FHD page on one thread  "
          f"[{card_line}]", flush=True)
    return {w: seen["solve_s"][0] for w, (_, seen) in runs.items()}


def ba_window_problem(scene, F: int = 8, slots: int = 2048,
                      points: int = 4096, seed: int = 77):
    """The headline's BA window shape from its scene: F frames of ``slots``
    keypoint slots over a ``points`` table whose first rows are the scene's
    landmarks; each frame observes the landmarks it sees (0.3 px noise),
    the poses after the first are perturbed by 0.02 and the points by 0.05
    (tests/test_parallel.py's problem at this size)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.geometry.rotations import \
        matrix_to_rodrigues

    import torch

    rng = np.random.default_rng(seed)
    n_real = min(len(scene.points), points)
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2],
                   scene.K[1, 2]], np.float32)
    uv = np.zeros((F, slots, 2), np.float32)
    idx = np.zeros((F, slots), np.int32)
    mask = np.zeros((F, slots), bool)
    cams = np.zeros((F, 6), np.float32)
    for f in range(F):
        uvf, vis = scene.project(f, noise=0.3, rng=rng)
        seen = np.flatnonzero(vis[:n_real])[:slots]
        uv[f, :len(seen)] = uvf[seen]
        idx[f, :len(seen)] = seen
        mask[f, :len(seen)] = True
        aa = matrix_to_rodrigues(torch.from_numpy(
            scene.rotations[f].astype(np.float32))).numpy()
        cams[f, :3] = aa + (rng.normal(0, 0.02, 3) if f else 0)
        cams[f, 3:] = scene.translations[f] + (rng.normal(0, 0.02, 3)
                                               if f else 0)
    pts = np.zeros((points, 3), np.float32)
    pts[:n_real] = scene.points[:n_real] + rng.normal(0, 0.05, (n_real, 3))
    pmask = np.zeros(points, bool)
    pmask[:n_real] = True
    return K4, cams, pts, uv, idx, mask, pmask


def shard_phase(card_line: str, scene, frames):
    """Eight virtual shards on cuda:0.  ``ShardedFrontend`` on 16 FHD
    frames (two a shard), SIFT/L2 and ORB/Hamming: the unsplit call's match
    counts exactly, 8 ``top2_batch`` launches per call.  ``ShardedBA`` at
    the headline's BA shape (8 frames, 4096 window points, Huber 2, 10 LM
    iterations) held to ``bundle_adjust_window`` with
    tests/test_parallel.py's rule → ({path: launches}, BA seconds)."""
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.models import frontend as fe
    from slam_indoor_code_tpu_torch.parallel import (ShardedBA,
                                                     ShardedFrontend,
                                                     make_mesh)
    from slam_indoor_code_tpu_torch.solver.ba import (BAConfig,
                                                      bundle_adjust_window)

    cuda0 = torch.device("cuda", 0)
    mesh = make_mesh((8,), ("batch",), devices=[cuda0] * 8)
    rgb = torch.from_numpy(np.stack(frames[1:17])).to(cuda0)
    launches = {}
    for path, desc, metric in (("shard", "sift", "l2"),
                               ("shard (hamming)", "orb", "hamming")):
        fcfg = fe.FrontendConfig(max_keypoints=2048, threshold=20.0,
                                 descriptor=desc, ratio=0.8, metric=metric)
        sf = ShardedFrontend(mesh, fcfg)
        cand = sf.extract_and_describe_batch(rgb)
        prev = fe.extract_and_describe(fcfg, torch.from_numpy(
            frames[0]).to(cuda0))
        fmask = torch.ones(16, dtype=torch.bool, device=cuda0)
        torch.cuda.synchronize()
        reset_counts()
        m_sh, sh_s = sync_time(lambda: sf.match_against_batch(
            prev["desc"], prev["valid"], cand["desc"], cand["valid"], fmask))
        n = counts()
        m_ref, ref_s = sync_time(lambda: fe.match_against_batch(
            fcfg, prev["desc"], prev["valid"], cand["desc"], cand["valid"],
            fmask))
        if n["top2_batch"] != 8 or n["plain"]:
            fail(f"{path}: {n['top2_batch']} top2_batch launches for 8 "
                 f"shards ({n})")
        if metric == "hamming" and n["hamming"] != 8:
            fail(f"{path}: {n['hamming']} Hamming launches for 8 shards")
        got = m_sh["num_matches"].cpu().numpy()
        want = m_ref["num_matches"].cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"{path}: sharded match counts {got.tolist()} differ from "
                 f"the unsplit call's {want.tolist()}")
        if not int(got[0]) > 100:
            fail(f"{path}: only {int(got[0])} matches on the next frame")
        launches[path] = n["top2_batch"]
        print(f"{path}: ShardedFrontend ({desc}/{metric}) on 8 virtual "
              f"shards of cuda:0, B=16 FHD frames: counts equal the unsplit "
              f"call's exactly {got.tolist()}; 8 top2_batch launches; "
              f"sharded match {1e3 * sh_s:.3f} ms, unsplit "
              f"{1e3 * ref_s:.3f} ms (host clock, synchronised)  "
              f"[{card_line}]", flush=True)

    prob = ba_window_problem(scene)
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=10)
    dev_args = [torch.from_numpy(a).to(cuda0) for a in prob]
    (_, cams_s, pts_s, info), single_s = sync_time(
        lambda: bundle_adjust_window(cfg, *dev_args))
    res, sharded_s = sync_time(
        lambda: ShardedBA(mesh, cfg, window=8).solve(*prob))
    cams_s = cams_s.cpu().numpy()
    pts_s = pts_s.cpu().numpy()
    fc = float(info["final_cost"])
    real = prob[6]
    dcam = float(np.abs(res.cams - cams_s).max())
    dpt = np.linalg.norm(res.points[real] - pts_s[real], axis=1)
    if not (dcam < 5e-3 and res.final_cost < 0.2 * res.initial_cost
            and abs(res.final_cost - fc) / fc < 0.05
            and float(np.abs(res.points[real] - pts_s[real]).max()) < 0.15
            and float(np.median(dpt)) < 0.05):
        fail(f"shard BA: cams max|d| {dcam:.3g}, cost {res.initial_cost:.3f}"
             f" -> {res.final_cost:.3f} vs single {fc:.3f}, points max|d| "
             f"{float(np.abs(res.points[real] - pts_s[real]).max()):.3g} "
             f"median {float(np.median(dpt)):.3g}")
    print(f"shard BA: ShardedBA on 8 virtual shards of cuda:0, 8 frames x "
          f"2048 slots, {int(real.sum())} of 4096 window points, Huber 2, "
          f"10 LM iterations: cost {res.initial_cost:.3f} -> "
          f"{res.final_cost:.3f} (bundle_adjust_window {fc:.3f}, "
          f"{info['num_iters']} iterations), cams max|d| {dcam:.3g}, points "
          f"median |d| {float(np.median(dpt)):.3g}; solve {sharded_s:.4f} s "
          f"sharded, {single_s:.4f} s single  [{card_line}]", flush=True)
    return launches, sharded_s


def mesh_phase(card_line: str, scene, frames, gd_l2):
    """``slam_main`` on the headline with ``mesh_shape=(cards,)``: on one
    card it must equal the L2 main path bit for bit → launch counts."""
    import torch

    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as out:
        cfg = headline_config(out)
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, mesh_shape=(n_cards,)))
        n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
    what = "mesh"
    if engine.mesh is None or engine.mesh.size != n_cards:
        fail(f"{what}: the engine built the mesh {engine.mesh}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(f"{what} ({n_cards} card(s))", n_cams, ate_pct, gd, wall, n,
           card_line)
    if n_cards == 1:
        same_run("mesh (1 card) and the L2 main path", gd_l2, gd,
                 tag="mesh:")
    return n


def sequences_phase(card_line: str, scene, frames, gd_l2):
    """``run_sequences_parallel`` on two 32-frame FHD sequences (the
    headline scene, and the same hallway from scene seed 8; RANSAC seed 0
    both), each thread on a CUDA stream of its own: each equals its own
    solo run (``slam_main`` on the default stream) bit for bit; the
    parallel wall beside the sum of the two solo walls, taken warm just
    before it → launch counts of the parallel run."""
    import torch

    from slam_indoor_code_tpu_torch.app import run_sequences_parallel

    scene2, frames2 = headline_scene(seed=8)
    solos, walls = [], []
    for sc, fr in ((scene, frames), (scene2, frames2)):
        with tempfile.TemporaryDirectory() as out:
            _, gd, wall, _, _ = slam_run(headline_config(out), sc, fr)
        solos.append(gd)
        walls.append(wall)
    same_run("solo headline (warm) and the L2 main path", gd_l2, solos[0],
             tag="sequences:")
    with tempfile.TemporaryDirectory() as o0, \
            tempfile.TemporaryDirectory() as o1:
        cfgs = [headline_config(o0), headline_config(o1)]
        torch.cuda.synchronize()
        reset_counts()
        out, wall = sync_time(lambda: run_sequences_parallel(
            cfgs, [scene.K, scene2.K], [frames, frames2], seeds=[0, 0]))
        n = counts()
    if n["plain"] or n["top2_l1"] or n["top2_pair"] or n["hamming"]:
        fail(f"sequences: launched another kernel than top2_batch: {n}")
    for i, (sc, gd, solo) in enumerate(zip((scene, scene2), out, solos)):
        n_cams, ate_pct = trajectory_ok(f"sequence {i}", sc, gd)
        same_run(f"sequence {i} and its solo run", solo, gd,
                 tag="sequences:")
        print(f"sequences: sequence {i} cameras {n_cams}/{N_FRAMES} ATE "
              f"{ate_pct:.4f}% of extent", flush=True)
    if n["top2_batch"] < len(out[0].rotations) + len(out[1].rotations) - 2:
        fail(f"sequences: {n['top2_batch']} top2_batch launches for "
             f"{len(out[0].rotations)} + {len(out[1].rotations)} cameras")
    print(f"sequences: two 32-frame FHD sequences on "
          f"{torch.cuda.device_count()} card(s), one thread and CUDA stream "
          f"each: wall {wall:.3f} s against the solo walls {walls[0]:.3f} + "
          f"{walls[1]:.3f} = {sum(walls):.3f} s (ratio "
          f"{wall / sum(walls):.3f}); launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)
    return n, wall, walls


def distributed_phase(card_line: str):
    """Two worker processes (``parallel/worker.py ba``) run
    ``ShardedBA.solve_multiprocess`` across the process boundary on the
    card at the headline's BA shape (gloo with both ranks on cuda:0 on one
    card, NCCL where each rank has its own): final cost within 1e-3
    relative and cameras within 5e-4 of the one-process solve, checked by
    each worker → the workers' lines."""
    import re
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slam_indoor_code_tpu_torch.parallel.worker",
         "ba", f"127.0.0.1:{port}", "2", str(r), "--device", "cuda",
         "--frames", "8", "--slots", "2048", "--points", "4096"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo, env=env) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    wall = time.perf_counter() - t
    lines = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        m = re.search(r"^proc \d .*cross-process BA cost.* OK$", out, re.M)
        if p.returncode != 0 or m is None:
            fail(f"distributed: rank {r} exit {p.returncode}:\n"
                 f"{out[-2500:]}")
        lines.append(m.group(0))
    for ln in lines:
        print(f"distributed: {ln}  [{card_line}]", flush=True)
    print(f"distributed: two processes, {wall:.3f} s from spawn to exit",
          flush=True)
    return lines


def main() -> None:
    name, card_line = card()
    phase("card", device=repr(name))
    try:
        secs = build()
        hmma = tensor_core_instructions()
        phase("build", nvcc_s=f"{secs:.2f}", hmma=json.dumps(hmma))
        rows = kernels()
        phase("kernels", **{r["name"].replace(" ", ""): (
            f"{r['ms']:.4f}ms(plain={r['plain_ms']:.4f},"
            f"bound={r['bound_ms']:.5f},err={r['max_abs_err']:.3g})")
            for r in rows.values()})
        scene, frames = headline_scene()
        phase("render", frames=N_FRAMES)
        count_plain_calls()
        n, gd_l2, logged_l2 = main_path(card_line, scene, frames)
        rows["top2_batch"]["launches"] = n["top2_batch"]
        # top2_batch's launches on each path that runs it
        by_path = {"main": n["top2_batch"]}
        rows["top2_batch"]["launches_by_path"] = by_path
        for lpb in (2, 4):
            rows[f"lpb{lpb}"]["launches"] = n["lpb"]
        phase("main", top2_batch_launches=n["top2_batch"])
        n, gd_l1 = l1_path(card_line, scene, frames)
        rows["top2_l1"]["launches"] = n["top2_l1"]
        phase("l1", top2_l1_launches=n["top2_l1"])
        n, gd_orb = orb_path(card_line, scene, frames)
        rows["hamming"]["launches"] = n["hamming"]
        by_path["orb (hamming)"] = n["hamming"]
        phase("orb", hamming_launches=n["hamming"])
        n, rec = global_path(card_line, scene, frames, gd_l2)
        by_path["global"] = n["top2_batch"]
        phase("global", top2_batch_launches=n["top2_batch"],
              solve_s=f"{rec['solve_s']:.3f}")
        n = resume_path(card_line, scene, frames, gd_l2)
        by_path["resume"] = n["top2_batch"]
        phase("resume", top2_batch_launches=n["top2_batch"])
        n, gd_stream = stream_path(card_line, scene, frames)
        by_path["stream"] = n["top2_batch"]
        phase("stream", top2_batch_launches=n["top2_batch"])
        n, gd_hybrid, engine = hybrid_path(card_line, scene, frames)
        rows["d384"]["launches"] = n["top2_batch"]
        by_path["hybrid (D=384)"] = n["top2_batch"]
        err = hold_on_ring(engine, "l2", "top2_batch on the hybrid ring")
        phase("hybrid", top2_batch_launches=n["top2_batch"],
              ring_max_abs_err=f"{err:.3g}")
        n, _, engine = hostorb_path(card_line, scene, frames)
        rows["host_words"] = host_words_row(engine)
        rows["host_words"]["launches"] = n["hamming"]
        by_path["hostorb (hamming)"] = n["hamming"]
        del engine
        phase("hostorb", hamming_launches=n["hamming"])
        n = pair_entry(card_line, frames)
        rows["top2_pair"]["launches"] = n["top2_pair"]
        phase("pair", top2_pair_launches=n["top2_pair"])
        n, gd_classic = classic_path(card_line, scene, frames)
        by_path["classic"] = n["top2_batch"]
        phase("classic", top2_batch_launches=n["top2_batch"])
        n = telemetry_path(card_line, scene, frames, gd_l2, logged_l2)
        by_path["telemetry"] = n["top2_batch"]
        phase("telemetry", top2_batch_launches=n["top2_batch"])
        cli_counts, cli_poses = cli_path(card_line, scene, frames, logged_l2)
        phase("cli")
        media_root = tempfile.mkdtemp()
        jpeg_written = jpeg_files(frames, os.path.join(media_root, "jpegs"))
        written = write_photo_glob(frames, media_root)
        mpng_path = mpng_video(frames, media_root)
        clis, clis_s, build_s = fixture_clis(scene, mpng_path,
                                             written["pattern"], jpeg_written)
        phase("fixture-clis", runs=len(clis), subprocess_s=f"{clis_s:.3f}",
              decoders_build_s=f"{build_s:.3f}",
              photo_glob_write_ms_per_frame=f"{written['write_ms']:.1f}")
        n, poses_jpeg, jpegs, decoded = jpeg_phase(
            card_line, scene, frames, gd_l2, jpeg_written, clis["jpeg"])
        jpeg_counts = n
        by_path["jpeg (cli)"] = n["top2_batch"]
        phase("jpeg", top2_batch_launches=n["top2_batch"])
        n = video_phase(card_line, scene, jpegs, decoded, poses_jpeg,
                        jpeg_written, clis["video"])
        by_path["video (cli)"] = n["top2_batch"]
        phase("video", top2_batch_launches=n["top2_batch"])
        n, dec3_ms, dec1_ms, track_ms = progjpeg_phase(
            card_line, scene, frames, decoded, poses_jpeg, jpeg_written,
            clis["progjpeg"])
        by_path["progjpeg (cli)"] = n["top2_batch"]
        phase("progjpeg", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame_3_workers=f"{dec3_ms:.3f}",
              decode_ms_per_frame_1_thread=f"{dec1_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, dec1_ms, track_ms = tiffjpeg_phase(
            card_line, decoded, poses_jpeg, jpeg_counts, jpeg_written,
            clis["tiffjpeg"])
        by_path["tiffjpeg (cli)"] = n["top2_batch"]
        del jpegs, decoded
        phase("tiffjpeg", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame_1_thread=f"{dec1_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, damaged_ms = damaged_phase(card_line, jpeg_written,
                                      clis["damaged"])
        del jpeg_written
        by_path["damaged (cli)"] = n["top2_batch"]
        phase("damaged", top2_batch_launches=n["top2_batch"],
              decode_ms_1_thread=json.dumps(
                  {k: round(v, 3) for k, v in damaged_ms.items()}))
        n, dec1_ms, track_ms = jp2_phase(card_line, clis["jp2"])
        by_path["jp2 (cli)"] = n["top2_batch"]
        phase("jp2", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame_1_thread=f"{dec1_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n = mp4_phase(card_line, scene, clis["mp4"])
        by_path["mp4 (cli)"] = n["top2_batch"]
        phase("mp4", top2_batch_launches=n["top2_batch"])
        n, decode_ms, track_ms, n_il, il_ms, il_track = asp_phase(
            card_line, scene, clis["asp"], clis["asp-il"])
        by_path["asp (cli)"] = n["top2_batch"]
        by_path["asp interlaced (cli)"] = n_il["top2_batch"]
        phase("asp", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}",
              interlaced_top2_batch_launches=n_il["top2_batch"],
              interlaced_decode_ms_per_frame=f"{il_ms:.3f}",
              interlaced_tracking_ms_per_frame=f"{il_track:.3f}")
        n, decode_ms, track_ms = webm_phase(card_line, scene,
                                            clis["webm"])
        by_path["webm (cli)"] = n["top2_batch"]
        phase("webm", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, decode_ms, track_ms = vp9_phase(card_line, scene,
                                           clis["vp9"])
        by_path["vp9 (cli)"] = n["top2_batch"]
        phase("vp9", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, decode_ms, track_ms = mpeg2_phase(card_line, scene,
                                             clis["mpeg2"])
        by_path["mpeg2 (cli)"] = n["top2_batch"]
        phase("mpeg2", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, decode_ms, track_ms = h263_phase(card_line, scene,
                                            clis["h263"])
        by_path["h263 (cli)"] = n["top2_batch"]
        phase("h263", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, decode_ms, track_ms = flv_phase(card_line, scene, clis["flv"])
        by_path["flv (cli)"] = n["top2_batch"]
        phase("flv", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, decode_ms, track_ms = mpng_phase(card_line, frames, mpng_path,
                                            clis["mpng"], cli_counts,
                                            cli_poses)
        by_path["mpng (cli)"] = n["top2_batch"]
        phase("mpng", top2_batch_launches=n["top2_batch"],
              decode_ms_per_frame=f"{decode_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}")
        n, ffv1_ms, hyuv_ms, track_ms, warm_ms = lossless_phase(
            card_line, frames, logged_l2, clis["lossless"],
            clis["lossless-warm"])
        by_path["lossless (cli)"] = n["top2_batch"]
        phase("lossless", top2_batch_launches=n["top2_batch"],
              ffv1_decode_ms_per_frame=f"{ffv1_ms:.3f}",
              huffyuv_decode_ms_per_frame=f"{hyuv_ms:.3f}",
              tracking_ms_per_frame=f"{track_ms:.3f}",
              tracking_ms_per_frame_warm=f"{warm_ms:.3f}")
        n = realtex_phase(card_line)
        by_path["realtex"] = n["top2_batch"]
        phase("realtex", top2_batch_launches=n["top2_batch"])
        calib_s = calibrate_phase(card_line, scene)
        solves = calibrate_pixels(card_line, scene, frames)
        phase("calibrate", solve_s=f"{calib_s:.4f}",
              photos_solve_s=f"{solves['photos']:.4f}",
              video_solve_s=f"{solves['video']:.4f}")
        shard_launches, shard_ba_s = shard_phase(card_line, scene, frames)
        by_path.update(shard_launches)
        phase("shard", top2_batch_launches=json.dumps(shard_launches),
              ba_s=f"{shard_ba_s:.4f}")
        n = mesh_phase(card_line, scene, frames, gd_l2)
        by_path["mesh"] = n["top2_batch"]
        phase("mesh", top2_batch_launches=n["top2_batch"])
        n, seq_wall, solo_walls = sequences_phase(card_line, scene, frames,
                                                  gd_l2)
        by_path["sequences"] = n["top2_batch"]
        phase("sequences", top2_batch_launches=n["top2_batch"],
              wall_s=f"{seq_wall:.3f}",
              solo_s=f"{solo_walls[0]:.3f}+{solo_walls[1]:.3f}")
        distributed_phase(card_line)
        phase("distributed")
        scene4k, frames4k = fourk_scene()
        n, _, engine = fourk_path(card_line, scene4k, frames4k,
                                  rows["d384_4k"]["ms"],
                                  rows["d384_4k"]["bound_ms"])
        rows["d384_4k"]["launches"] = n["top2_batch"]
        by_path["4k (D=384)"] = n["top2_batch"]
        err = hold_on_ring(engine, "l2", "top2_batch on the 4K ring")
        del engine, frames4k
        phase("4k", top2_batch_launches=n["top2_batch"],
              ring_max_abs_err=f"{err:.3g}")
        _, again, _ = main_path(card_line, scene, frames, "main path, run 2")
        same_run("main path", gd_l2, again)
        _, again = classic_path(card_line, scene, frames,
                                "classic path, run 2")
        same_run("classic path", gd_classic, again)
        _, again = l1_path(card_line, scene, frames, "l1 path, run 2")
        same_run("l1 path", gd_l1, again)
        _, again = orb_path(card_line, scene, frames, "orb path, run 2")
        same_run("orb path", gd_orb, again)
        _, again = stream_path(card_line, scene, frames, "stream path, run 2")
        same_run("stream path", gd_stream, again)
        _, again, _ = hybrid_path(card_line, scene, frames,
                                  "hybrid path, run 2")
        same_run("hybrid path", gd_hybrid, again)
        phase("repro", runs=12)
        n, times, track_ms = photos_phase(card_line, frames, cli_counts,
                                          cli_poses, written, clis["photos"])
        shutil.rmtree(media_root)
        by_path["photos (cli)"] = n["top2_batch"]
        phase("photos", top2_batch_launches=n["top2_batch"],
              tracking_ms_per_frame=f"{track_ms:.3f}", **{
                  name.split(",")[0].replace(" ", "_"):
                  f"{a:.3f}/{b:.3f}ms" for name, (a, b) in times.items()})
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 — every phase failure fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
    import torch

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
