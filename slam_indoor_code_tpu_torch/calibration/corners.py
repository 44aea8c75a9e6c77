"""Chessboard inner-corner detection on the host, in numpy and scipy: the
port's counterpart of OpenCV's ``findChessboardCorners`` and
``cornerSubPix``, which the JAX package calls
(slam_indoor_code_tpu/calibration/chessboard.py:39-55).

Two stages:

1. ``corner_subpix`` is OpenCV's ``cornerSubPix`` written out: for each
   corner, the (2·win+3)² bilinear patch around the current estimate
   (``getRectSubPix``, replicated border, float32), central-difference
   gradients weighted by the separable ``exp(-x²)`` mask, and the 2×2
   normal equations Σ g gᵀ q = Σ g gᵀ p solved in float64; it stops when
   the squared shift is at most eps² or after ``max_iter`` iterations, and
   falls back to the start where the result left the window.
2. ``find_corners`` finds the inner corners as saddle points of the
   smoothed image (the Hessian determinant, non-maximum suppression),
   grows a lattice from a seed cell by local homography prediction,
   taking a saddle only where the four cells around it alternate (an
   X-junction, not one of the board's outer L-corners), and rejects a
   lattice that is incomplete, of another size, not monotone along its
   rows and columns, whose cells do not alternate dark and light, or that
   comes within ``BORDER`` pixels of the image edge.  It returns
   the corners in OpenCV's order after OpenCV's own closing pass (a 5×5
   ``cornerSubPix``), so that the caller's refinement starts where
   OpenCV's does: from starts a pixel apart, 30 iterations of the 11×11
   window can stop a tenth of a pixel apart on a foreshortened board.

OpenCV's order comes out of its quad graph: the black squares, found as
holes of a binarised and dilated image in raster order, are walked from
the first; each square's first vertex is where the polygon fit of its
contour starts.  ``_opencv_order`` replays that walk on the lattice: the
binarised image is the first of OpenCV's (its histogram level with 1 to 7
dilations, then its adaptive levels) in which the black squares are
separate holes, each square's contour starts at its first pixel in raster
order, and its first vertex is the far end of the diagonal found from
there, as ``approxPolyDP`` finds it.  Where none separates the squares (a
board blurred at the scale of its cells), OpenCV finds no board, and
neither does this detector.  The order matters for the per-view R and t
that calibration stores; K does not depend on it.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.spatial import cKDTree

# OpenCV rejects a board with a corner this close to the image edge
BORDER = 8
# saddle detection: Gaussian scale, suppression window, candidates kept;
# the scale of a second search where the first finds no board (a bilevel
# image, a scanned or faxed page: its pixel-wide steps make saddles of
# their own at the first scale, which crowd out the board's)
SMOOTH_SIGMA = 1.5
WIDE_SIGMA = 3.0
NMS_SIZE = 5
MAX_CANDIDATES = 400
MAX_SEEDS = 40
# gray levels between a board's dark and light cells, at the least
MIN_CONTRAST = 8.0
# OpenCV's detector dilates its histogram binarisation 1 to 7 times and
# each adaptive one 0 to 7 times
DILATIONS = 7


# ---------------------------------------------------------- cornerSubPix
def _rect_subpix(img: np.ndarray, centers: np.ndarray, w: int,
                 h: int) -> np.ndarray:
    """``getRectSubPix`` of a u8 image into float32 [N, h, w] patches
    centred on ``centers`` [N,2] (x, y), replicated border."""
    H, W = img.shape
    c = centers.astype(np.float32) - np.float32([(w - 1) * 0.5,
                                                 (h - 1) * 0.5])
    ip = np.floor(c)
    a, b = (c - ip)[:, 0, None, None], (c - ip)[:, 1, None, None]
    ip = ip.astype(np.int64)
    cols = np.clip(ip[:, 0, None] + np.arange(w + 1), 0, W - 1)
    rows = np.clip(ip[:, 1, None] + np.arange(h + 1), 0, H - 1)
    p = img[rows[:, :, None], cols[:, None, :]].astype(np.float32)
    one = np.float32(1)
    return ((one - a) * (one - b) * p[:, :-1, :-1]
            + a * (one - b) * p[:, :-1, 1:]
            + (one - a) * b * p[:, 1:, :-1] + a * b * p[:, 1:, 1:])


def _subpix_mask(win, zero_zone) -> np.ndarray:
    ww, wh = win
    y = ((np.arange(2 * wh + 1) - wh) / np.float32(wh)).astype(np.float32)
    x = ((np.arange(2 * ww + 1) - ww) / np.float32(ww)).astype(np.float32)
    mask = (np.exp(-y * y)[:, None] * np.exp(-x * x)[None, :]).astype(
        np.float32)
    zw, zh = zero_zone
    if zw >= 0 and zh >= 0 and 2 * zw + 1 < 2 * ww + 1 \
            and 2 * zh + 1 < 2 * wh + 1:
        mask[wh - zh:wh + zh + 1, ww - zw:ww + zw + 1] = 0
    return mask.astype(np.float64)


def corner_subpix(img8: np.ndarray, corners: np.ndarray, win=(11, 11),
                  zero_zone=(-1, -1), max_iter: int = 30,
                  eps: float = 1e-3) -> np.ndarray:
    """``cv2.cornerSubPix(img8, corners, win, zero_zone,
    (EPS + MAX_ITER, max_iter, eps))`` on a u8 image: refined [N,2]
    float32 corners (x, y)."""
    img8 = np.asarray(img8, np.uint8)
    H, W = img8.shape
    ww, wh = win
    if ww <= 0 or wh <= 0 or W < 2 * ww + 5 or H < 2 * wh + 5:
        raise ValueError(f"corner_subpix: window {win} does not fit a "
                         f"{H}x{W} image")
    mask = _subpix_mask(win, zero_zone)
    px = (np.arange(2 * ww + 1) - ww).astype(np.float64)[None, None, :]
    py = (np.arange(2 * wh + 1) - wh).astype(np.float64)[None, :, None]
    start = np.asarray(corners, np.float32).reshape(-1, 2).copy()
    if not ((start[:, 0] >= 0) & (start[:, 0] < W) & (start[:, 1] >= 0)
            & (start[:, 1] < H)).all():
        raise ValueError("corner_subpix: a corner lies outside the image")
    iters = min(max(max_iter, 1), 100)
    eps2 = max(eps, 0.0) ** 2
    cur = start.copy()
    active = np.arange(len(cur))
    for _ in range(iters):
        if not len(active):
            break
        sub = _rect_subpix(img8, cur[active], 2 * ww + 3, 2 * wh + 3)
        gx = (sub[:, 1:-1, 2:] - sub[:, 1:-1, :-2]).astype(np.float64)
        gy = (sub[:, 2:, 1:-1] - sub[:, :-2, 1:-1]).astype(np.float64)
        gxx, gxy, gyy = gx * gx * mask, gx * gy * mask, gy * gy * mask
        a = gxx.sum((1, 2))
        b = gxy.sum((1, 2))
        c = gyy.sum((1, 2))
        bb1 = (gxx * px + gxy * py).sum((1, 2))
        bb2 = (gxy * px + gyy * py).sum((1, 2))
        det = a * c - b * b
        solvable = np.abs(det) > np.finfo(np.float64).eps ** 2
        scale = 1.0 / np.where(solvable, det, 1.0)
        old = cur[active]
        new = np.stack([old[:, 0] + c * scale * bb1 - b * scale * bb2,
                        old[:, 1] - b * scale * bb1 + a * scale * bb2],
                       1).astype(np.float32)
        new = np.where(solvable[:, None], new, old)
        d = new - old
        err = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        cur[active] = new
        inside = ((new[:, 0] >= 0) & (new[:, 0] < W) & (new[:, 1] >= 0)
                  & (new[:, 1] < H))
        active = active[solvable & inside & (err > eps2)]
    far = ((np.abs(cur[:, 0] - start[:, 0]) > ww)
           | (np.abs(cur[:, 1] - start[:, 1]) > wh))
    cur[far] = start[far]
    return cur


# ------------------------------------------------------- saddle candidates
def _saddles(g: np.ndarray):
    """Candidate X-junctions of the smoothed image ``g``: local maxima of
    −det(Hessian), strongest first, [K,2] (x, y)."""
    fxx = np.zeros_like(g)
    fyy = np.zeros_like(g)
    fxy = np.zeros_like(g)
    fxx[:, 1:-1] = g[:, 2:] - 2 * g[:, 1:-1] + g[:, :-2]
    fyy[1:-1] = g[2:] - 2 * g[1:-1] + g[:-2]
    fxy[1:-1, 1:-1] = 0.25 * (g[2:, 2:] - g[2:, :-2] - g[:-2, 2:]
                              + g[:-2, :-2])
    resp = fxy * fxy - fxx * fyy
    peak = (resp == ndimage.maximum_filter(resp, NMS_SIZE)) & (resp > 0)
    ys, xs = np.nonzero(peak)
    r = resp[ys, xs]
    if not len(r):
        return np.zeros((0, 2))
    top = np.sort(r)[::-1]
    # relative to a strong saddle, robust against a few bright outliers
    ref = top[min(len(top) - 1, 20)]
    keep = r >= max(0.08 * ref, 1.0)
    order = np.argsort(-r[keep], kind="stable")[:MAX_CANDIDATES]
    return np.stack([xs[keep], ys[keep]], 1).astype(np.float64)[order]


def _bilinear(g: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return ndimage.map_coordinates(g, [y.ravel(), x.ravel()], order=1,
                                   mode="nearest").reshape(x.shape)


# ------------------------------------------------------------ the lattice
def _fit_h(src: np.ndarray, dst: np.ndarray):
    """Least-squares homography src→dst (DLT), or None if degenerate."""
    A = []
    for (X, Y), (u, v) in zip(src, dst):
        A.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        A.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, s, Vt = np.linalg.svd(np.asarray(A, np.float64))
    if s[-2] < 1e-9 * s[0]:
        return None
    return Vt[-1].reshape(3, 3)


def _predict(grid: dict, ij) -> np.ndarray | None:
    """Where lattice index ``ij`` should lie: a homography fitted to the
    known points nearest it in index space."""
    for reach in (2, 3, 99):
        near = [k for k in grid if max(abs(k[0] - ij[0]),
                                       abs(k[1] - ij[1])) <= reach]
        if len(near) < 4:
            continue
        Hm = _fit_h(np.array(near, np.float64),
                    np.array([grid[k] for k in near]))
        if Hm is not None:
            v = Hm @ np.array([ij[0], ij[1], 1.0])
            return v[:2] / v[2]
    return None


def _x_junction(g: np.ndarray, p, e1, e2) -> bool:
    """The four cells around ``p`` along the axes ``e1`` and ``e2`` are
    dark and light in turn: an X-junction of the board, not one of its
    outer L-corners (one dark cell, three light) nor a cell diagonal."""
    q = np.array([p + (a * e1 + b * e2) / 2
                  for a, b in ((1, 1), (-1, -1), (1, -1), (-1, 1))])
    v = _bilinear(g, q[:, 0], q[:, 1])
    spread = v.max() - v.min()
    gap = max(v[:2].min() - v[2:].max(), v[2:].min() - v[:2].max())
    return spread >= MIN_CONTRAST and gap > 0.5 * spread


def _axes(grid: dict, ij):
    """The lattice's two axis steps at the known pairs nearest ``ij``."""
    out = []
    for d in ((1, 0), (0, 1)):
        pairs = [(max(abs(k[0] - ij[0]), abs(k[1] - ij[1])), k)
                 for k in grid if (k[0] + d[0], k[1] + d[1]) in grid]
        if not pairs:
            return None
        k = min(pairs)[1]
        out.append(np.subtract(grid[(k[0] + d[0], k[1] + d[1])], grid[k]))
    return out


def _grow(g: np.ndarray, pts: np.ndarray, tree: cKDTree, seed: int,
          limit: int):
    """The lattice grown from candidate ``seed`` as ({(i, j): (x, y)}, the
    candidates it took), or (None, {}) when no seed cell exists.  Stops
    past ``limit`` indices in a direction."""
    if len(pts) < 4:
        return None, set()
    _, nn = tree.query(pts[seed], k=min(9, len(pts)))
    nn = [n for n in nn if n != seed]
    s = pts[seed]
    for n1, n2 in ((a, b) for i, a in enumerate(nn[:4]) for b in nn[i + 1:]):
        e1, e2 = pts[n1] - s, pts[n2] - s
        if abs(np.dot(e1, e2)) > 0.9 * np.linalg.norm(e1) * np.linalg.norm(e2):
            continue
        d4, n4 = tree.query(s + e1 + e2)
        if d4 <= 0.3 * min(np.linalg.norm(e1), np.linalg.norm(e2)) \
                and n4 not in (seed, n1, n2) \
                and all(_x_junction(g, pts[n], e1, e2)
                        for n in (seed, n1, n2, n4)):
            break
    else:
        return None, set()
    idx = {(0, 0): seed, (1, 0): n1, (0, 1): n2, (1, 1): n4}
    grid = {k: pts[v] for k, v in idx.items()}
    used = set(idx.values())
    frontier = list(idx)
    while frontier:
        nxt = []
        for k in frontier:
            for d in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ij = (k[0] + d[0], k[1] + d[1])
                if ij in grid:
                    continue
                ii = [i for i, _ in grid] + [ij[0]]
                jj = [j for _, j in grid] + [ij[1]]
                if max(ii) - min(ii) >= limit or max(jj) - min(jj) >= limit:
                    continue
                p = _predict(grid, ij)
                axes = _axes(grid, ij)
                if p is None or axes is None:
                    continue
                dist, n = tree.query(p)
                step = min(np.linalg.norm(axes[0]), np.linalg.norm(axes[1]))
                if dist > 0.3 * step or n in used \
                        or not _x_junction(g, pts[n], *axes):
                    continue
                grid[ij] = pts[n]
                used.add(n)
                nxt.append(ij)
        frontier = nxt
    return grid, used


def _monotone(P: np.ndarray) -> bool:
    """Every row and column of the [h, w, 2] lattice runs one way:
    projected on its end-to-end direction, strictly increasing."""
    for line in list(P) + list(P.transpose(1, 0, 2)):
        d = line[-1] - line[0]
        t = (line - line[0]) @ d / max(d @ d, 1e-12)
        if not (np.diff(t) > 0).all():
            return False
    return True


def _cell_means(g: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Mean of ``g`` around the centre of each cell of the [h, w, 2]
    lattice (a 3×3 sample grid over the middle half of the cell)."""
    a, b = P[:-1, :-1], P[:-1, 1:]
    c, d = P[1:, :-1], P[1:, 1:]
    vals = 0
    for s in (0.25, 0.5, 0.75):
        for t in (0.25, 0.5, 0.75):
            q = ((1 - s) * (1 - t) * a + s * (1 - t) * b + (1 - s) * t * c
                 + s * t * d)
            vals = vals + _bilinear(g, q[..., 0], q[..., 1])
    return vals / 9.0


def _alternates(g: np.ndarray, P: np.ndarray) -> bool:
    """The cells are dark and light in turn: every cell of one parity is
    darker than every cell of the other."""
    m = _cell_means(g, P)
    par = (np.add.outer(np.arange(m.shape[0]), np.arange(m.shape[1])) % 2
           ).astype(bool)
    lo, hi = (m[par], m[~par]) if m[par].mean() < m[~par].mean() \
        else (m[~par], m[par])
    return lo.max() < hi.min()


def _lattice(grid: dict, pattern_size):
    """The grown lattice as [h, w, 2] (rows along j) in a frame with
    positive handedness (x along i, y along j, clockwise on screen), or
    None unless it is complete and of the pattern's size."""
    ii = sorted({i for i, _ in grid})
    jj = sorted({j for _, j in grid})
    w, h = len(ii), len(jj)
    if len(grid) != w * h or {w, h} != set(pattern_size) \
            or ii[-1] - ii[0] != w - 1 or jj[-1] - jj[0] != h - 1:
        return None
    P = np.array([[grid[(i, j)] for i in ii] for j in jj], np.float64)
    e1, e2 = P[0, 1] - P[0, 0], P[1, 0] - P[0, 0]
    if e1[0] * e2[1] - e1[1] * e2[0] < 0:
        P = P.transpose(1, 0, 2)
    return P


# --------------------------------------------------------- OpenCV's order
def _histogram_threshold(img8: np.ndarray) -> int:
    """OpenCV's ``icvBinarizationHistogramBased`` level: white is
    ``img >= level``."""
    n = img8.size
    hist = np.bincount(img8.ravel(), minlength=256).astype(np.int64)
    lo = np.maximum(np.arange(256) - 1, 0)
    hi = np.minimum(np.arange(256) + 1, 255)
    cs = np.concatenate([[0], np.cumsum(hist)])
    smooth = (cs[hi + 1] - cs[lo]) // (hi - lo + 1)
    grad = np.zeros(256, np.int64)
    prev = 0
    for i in range(1, 255):
        gi = int(smooth[i - 1] - smooth[i + 1])
        if abs(gi) < 100:
            gi = -100 if prev == 0 else prev
        grad[i] = prev = gi
    maxima = []
    i = 254
    while i > 2 and len(maxima) < 20:
        if grad[i - 1] < 0 and grad[i] > 0:
            around = smooth[i - 1] + smooth[i] + smooth[i + 1]
            if not (around < n // 100 and i < 64):
                maxima.append(i)
        i -= 1
    if not maxima:
        return int(np.argmax(np.cumsum(hist) > n // 2))
    if len(maxima) == 1:
        return maxima[0] // 2
    if len(maxima) == 2:
        return (maxima[0] + maxima[1]) // 2
    acc, bright_idx = 0, 0
    for i in range(255, 0, -1):
        acc += hist[i]
        if acc > n // 18:
            bright_idx = i
            break
    bg, bright = 0, maxima[0]
    for k in range(len(maxima) - 1):
        bg = k + 1
        if maxima[k] < bright_idx:
            break
        bright = maxima[k]
    best = hist[maxima[bg]]
    if maxima[bg] >= 250 and bg + 1 < len(maxima):
        bg += 1
        best = hist[maxima[bg]]
    for k in range(bg + 1, len(maxima)):
        if hist[maxima[k]] >= best:
            best = hist[maxima[k]]
            bg = k
    return bright - (bright - maxima[bg]) // 2


def _squares(P: np.ndarray, dark_first: bool):
    """The board's black squares: for each, its four corners as lattice
    keys (x, y), clockwise on screen from the top-left in lattice terms,
    and their image positions, with the outer ring extrapolated."""
    h, w = P.shape[:2]
    E = np.zeros((h + 2, w + 2, 2))
    E[1:-1, 1:-1] = P
    E[0, 1:-1] = 2 * P[0] - P[1]
    E[-1, 1:-1] = 2 * P[-1] - P[-2]
    E[:, 0] = 2 * E[:, 1] - E[:, 2]
    E[:, -1] = 2 * E[:, -2] - E[:, -3]
    out = []
    for by in range(h + 1):
        for bx in range(w + 1):
            # cell (0, 0) of the lattice is square (1, 1)
            if ((bx + by) % 2 == 0) != dark_first:
                continue
            keys = [(bx - 1, by - 1), (bx, by - 1), (bx, by), (bx - 1, by)]
            out.append((keys, np.array([E[y + 1, x + 1] for x, y in keys])))
    return out


def _first_vertex(pts: np.ndarray, start) -> int:
    """Where ``approxPolyDP`` starts a closed contour that begins at
    ``start``: the far end of the diagonal found from there."""
    f1 = int(np.argmax(((pts - start) ** 2).sum(1)))
    return int(np.argmax(((pts - pts[f1]) ** 2).sum(1)))


def _equalize(img8: np.ndarray) -> np.ndarray:
    """OpenCV's ``equalizeHist``."""
    hist = np.bincount(img8.ravel(), minlength=256)
    i = int(np.argmax(hist > 0))
    if hist[i] == img8.size:
        return np.full_like(img8, i)
    scale = np.float32(255.0 / (img8.size - hist[i]))
    lut = np.zeros(256, np.uint8)
    lut[i + 1:] = np.clip(np.round(np.cumsum(hist[i + 1:]) * scale), 0, 255)
    return lut[img8]


def _binarisations(img8: np.ndarray, box):
    """The crop ``box`` = (y0, y1, x0, x1) of each binarised image OpenCV's
    detector tries, in its order (white True): its histogram level after 1
    to 7 dilations, then, on the equalised image, white above the mean of
    the block around (a side of 20 % or 10 % of the image's short side,
    less 0, 5 or 10 levels) after 0 to 7 dilations."""
    y0, y1, x0, x1 = box
    ring = np.ones((3, 3), bool)
    white = img8[y0:y1, x0:x1] >= _histogram_threshold(img8)
    for _ in range(DILATIONS):
        white = ndimage.binary_dilation(white, ring)
        yield white
    eq = _equalize(img8)
    for k in range(6):
        block = int(round(min(img8.shape) * (0.2 if k % 2 == 0 else 0.1))) | 1
        mean = np.round(ndimage.uniform_filter(eq.astype(np.float64), block,
                                               mode="nearest"))
        white = eq[y0:y1, x0:x1] > mean[y0:y1, x0:x1] - 5 * (k // 2)
        yield white
        for _ in range(DILATIONS):
            white = ndimage.binary_dilation(white, ring)
            yield white


def _pixel_quads(img8: np.ndarray, squares):
    """Each black square's contour start (first pixel in raster order of
    its hole) in the first of OpenCV's binarised images in which all the
    squares inside the image are separate holes (None for a square whose
    centre is outside); None if they never are."""
    H, W = img8.shape
    allp = np.concatenate([p for _, p in squares])
    m = 2 * DILATIONS + 6  # a crop the dilations do not reach across
    x0 = int(np.clip(np.floor(allp[:, 0].min()) - m, 0, W))
    y0 = int(np.clip(np.floor(allp[:, 1].min()) - m, 0, H))
    x1 = int(np.clip(np.ceil(allp[:, 0].max()) + m + 1, 0, W))
    y1 = int(np.clip(np.ceil(allp[:, 1].max()) + m + 1, 0, H))
    centres = np.round(np.array([p.mean(0) for _, p in squares])).astype(int)
    inside = ((centres[:, 0] >= 2) & (centres[:, 0] < W - 2)
              & (centres[:, 1] >= 2) & (centres[:, 1] < H - 2))
    cx, cy = centres[inside, 0] - x0, centres[inside, 1] - y0
    for white in _binarisations(img8, (y0, y1, x0, x1)):
        # OpenCV draws a white frame over the image's outer two pixels
        white = white.copy()
        if y0 == 0:
            white[:2] = True
        if x0 == 0:
            white[:, :2] = True
        if y1 == H:
            white[-2:] = True
        if x1 == W:
            white[:, -2:] = True
        lab, _ = ndimage.label(~white)
        ids = lab[cy, cx]
        if (ids == 0).any() or len(set(ids.tolist())) < len(ids):
            continue
        objs = ndimage.find_objects(lab)
        found = []
        for L in ids:
            sl = objs[L - 1]
            sub = lab[sl] == L
            r = int(np.argmax(sub.any(1)))
            c = int(np.argmax(sub[r]))
            # the hole's border starts at the white pixel to its left
            found.append((sl[0].start + r + y0, sl[1].start + c + x0 - 1))
        starts = iter(found)
        return [next(starts) if k else None for k in inside]
    return None


def _walk(quads, pos, pattern_size):
    """OpenCV's ``findConnectedQuads``, ``orderFoundConnectedQuads`` and
    ``checkQuadGroup`` on quads given in contour order as lists of corner
    keys (vertex 0 first, clockwise): the corner keys in OpenCV's order, or
    None where its walk fails."""
    n = len(quads)
    owner: dict = {}
    for q, keys in enumerate(quads):
        for k in keys:
            owner.setdefault(k, []).append(q)
    corners = [list(k) for k in quads]
    nbr = [[next((o for o in owner[k] if o != q), None) for k in keys]
           for q, keys in enumerate(quads)]
    count = [sum(x is not None for x in nb) for nb in nbr]
    # findConnectedQuads: depth first from the first linked quad
    seed = next((q for q in range(n) if count[q] > 0), None)
    if seed is None:
        return None
    group, seen, stack = [seed], {seed}, [seed]
    while stack:
        q = stack.pop()
        for o in nbr[q]:
            if o is not None and o not in seen:
                seen.add(o)
                stack.append(o)
                group.append(o)
    # orderFoundConnectedQuads: inner quads take the first inner quad's
    # vertex numbering (orderQuad)
    start = next((q for q in group if count[q] == 4), None)
    if start is None:
        return None
    ordered, stack = {start}, [start]
    while stack:
        q = stack.pop()
        for i in range(4):
            o = nbr[q][i]
            if o is None or o in ordered or count[o] != 4:
                continue
            tc = corners[o].index(corners[q][i])
            while tc != (i + 2) & 3:
                corners[o] = corners[o][-1:] + corners[o][:-1]
                nbr[o] = nbr[o][-1:] + nbr[o][:-1]
                tc = (tc + 1) & 3
            ordered.add(o)
            stack.append(o)
    # checkQuadGroup
    ROW1, ROW2, ROW_ = 1_000_000, 2_000_000, 3_000_000
    row: dict = {}
    links: dict = {}
    seq = []
    for q in group:
        for j in range(4):
            if nbr[q][j] is None:
                continue
            a, b = corners[q][j], corners[q][(j + 1) & 3]
            flag = ROW1 if count[q] == 1 else ROW2 if count[q] == 2 else ROW_
            links.setdefault(a, [])
            links.setdefault(b, [])
            if row.get(a, 0) == 0:
                seq.append(a)
                row[a] = flag
            elif row[a] > flag:
                row[a] = flag
            if nbr[q][(j + 1) & 3] is not None:
                if len(links[a]) >= 4 or len(links[b]) >= 4 \
                        or b in links[a]:
                    return None
                links[a].append(b)
                links[b].append(a)
    pw, ph = pattern_size
    if len(seq) != pw * ph:
        return None
    first = first2 = None
    for c in seq:
        if first is None and len(links[c]) == 2:
            if row[c] == ROW1:
                first = c
            elif first2 is None and row[c] == ROW2:
                first2 = c
    first = first or first2
    hist = np.bincount([len(links[c]) for c in seq], minlength=5)
    if first is None or hist[0] or hist[1] or hist[2] != 4 \
            or hist[3] != 2 * (pw + ph) - 8:
        return None
    right = below = None
    for c in links[first]:
        if right is None:
            right = c
        elif below is None:
            below = c
    if right is None or below is None or len(links[right]) not in (2, 3) \
            or len(links[below]) not in (2, 3):
        return None
    rows_of = {c: row.get(c, 0) for c in links}
    out = [first]
    rows_of[first] = 0
    next_first = below
    while True:
        rows_of[right] = 0
        out.append(right)
        if len(links[right]) == 2:
            break
        if len(links[right]) != 3 or len(out) >= max(pw, ph):
            return None
        cur = right
        for c in links[cur]:
            if rows_of[c] > 0:
                if below in links[c]:
                    below = c
                else:
                    right = c
    width = len(out)
    if width not in (pw, ph):
        return None
    height = ph if width == pw else pw
    i = 1
    while next_first is not None:
        cur, next_first, j = next_first, None, 0
        while True:
            rows_of[cur] = i
            out.append(cur)
            if len(links[cur]) == 2 + (i < height - 1) and j > 0:
                break
            right = None
            for c in links[cur]:
                if rows_of[c] > i:
                    if any(rows_of[x] == i - 1 for x in links[c]):
                        right = c
                        if j > 0:
                            break
                    elif j == 0:
                        next_first = c
            if right is None:
                return None
            cur = right
            j += 1
        if j != width - 1:
            return None
        i += 1
    if len(out) != len(seq):
        return None
    if width != pw:
        width, height = height, width
        out = [out[j * height + i] for i in range(height)
               for j in range(width)]
    p0, p1, p2 = pos(out[0]), pos(out[pw - 1]), pos(out[pw])
    d1, d2 = p1 - p0, p2 - p1
    if d1[0] * d2[1] - d1[1] * d2[0] < 0:
        out = list(out)
        if width % 2 == 0:
            for r in range(height):
                row = slice(r * width, (r + 1) * width)
                out[row] = out[row][::-1]
        else:
            for c in range(width):
                for r in range(height // 2):
                    a, b = r * width + c, (height - r - 1) * width + c
                    out[a], out[b] = out[b], out[a]
    return out


def _opencv_order(img8: np.ndarray, g: np.ndarray, P: np.ndarray,
                  pattern_size):
    """The [h, w, 2] lattice's corners [N,2] in OpenCV's order, or None
    where OpenCV's binarisation does not separate the black squares or its
    walk fails (OpenCV then finds no board either)."""
    m = _cell_means(g, P)
    squares = _squares(P, bool(m[0, 0] < m[0, 1]))
    starts = _pixel_quads(img8, squares)
    if starts is None:
        return None
    quads = []
    for (keys, pts), start in zip(squares, starts):
        # a square cut off by the image edge starts at its topmost vertex
        sy, sx = start or tuple(pts[np.lexsort(pts.T)[0]][::-1])
        k0 = _first_vertex(pts, np.array([sx, sy], np.float64))
        quads.append(((sy, sx), keys[k0:] + keys[:k0]))
    quads.sort(key=lambda q: q[0])

    def pos(key):
        return P[key[1], key[0]]

    out = _walk([k for _, k in quads], pos, pattern_size)
    return None if out is None else np.array([pos(k) for k in out])


# -------------------------------------------------------------- detection
def find_corners(img8: np.ndarray, pattern_size=(7, 7)):
    """The chessboard's inner corners [w·h, 2] (x, y) in OpenCV's order,
    after OpenCV's own closing ``cornerSubPix`` (a 5×5 window, 15
    iterations, eps 0.1), or None.  The lattice is sought at
    ``SMOOTH_SIGMA``, then, where none is found there, at ``WIDE_SIGMA``."""
    img8 = np.asarray(img8, np.uint8)
    for sigma in (SMOOTH_SIGMA, WIDE_SIGMA):
        corners = _find_at(img8, pattern_size, sigma)
        if corners is not None:
            return corners
    return None


def _find_at(img8: np.ndarray, pattern_size, sigma: float):
    """find_corners with the lattice sought at one smoothing scale."""
    H, W = img8.shape
    g = ndimage.gaussian_filter(img8.astype(np.float32), sigma,
                                truncate=3.0)
    pts = _saddles(g)
    if len(pts) < pattern_size[0] * pattern_size[1]:
        return None
    tree = cKDTree(pts)
    tried = set()
    for seed in range(min(len(pts), MAX_SEEDS)):
        if seed in tried:
            continue
        grid, used = _grow(g, pts, tree, seed, max(pattern_size) + 1)
        if grid is None:
            continue
        tried |= used
        P = _lattice(grid, pattern_size)
        if P is None or not _monotone(P) or not _alternates(g, P):
            continue
        corners = _opencv_order(img8, g, P, pattern_size)
        if corners is None:
            return None
        if ((corners[:, 0] <= BORDER) | (corners[:, 0] > W - BORDER)
                | (corners[:, 1] <= BORDER)
                | (corners[:, 1] > H - BORDER)).any():
            return None
        # OpenCV's own closing pass (calibinit.cpp), so that the caller's
        # refinement starts where OpenCV's does
        return corner_subpix(img8, corners, (2, 2), (-1, -1), 15, 0.1)
    return None
