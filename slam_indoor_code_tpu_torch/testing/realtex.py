"""Real-texture scene renderer (counterpart of the JAX package's
testing/realtex.py): end-to-end SLAM on textured pixels with exact ground
truth.

Every frame is a homography warp of each plane's texture through the true
camera pose, painted far to near with per-plane masks, so feature
extraction, matching, PnP, triangulation and BA run on real image
statistics while the poses stay exact.  Two planes at different depths give
genuine parallax.

The warps are OpenCV's ``warpPerspective`` written out in torch, on the
caller's device, as OpenCV 5 computes them for 8-bit images.  The
homography is inverted in float64 in closed form (``cv::invert``'s 3x3
path) and rounded to float32; each destination pixel's source coordinate
is ``fma(x, M0, row) / fma(x, M6, row)`` in float32, with each row's terms
``y*M1 + M2`` in float32 (``fma(x, M0, y*M1) + M2`` in the columns OpenCV
leaves to its scalar loop).  INTER_LINEAR floors it and blends the 2x2
neighbours with ``fma(alpha, p01 - p00, p00)`` across and then down,
rounded half to even; INTER_NEAREST rounds it half to even.  Outside the
texture is ``BORDER_CONSTANT`` (0 unless a border value is given).

A float32 FMA is computed in float64 and rounded once more (exact but for
a double rounding, which needs the float64 result to fall on a float32
tie).  Each torch op is one rounded IEEE operation on the CPU and on CUDA,
so the render is the same on both.  Textures are arguments: no photo is
read here.
"""

from __future__ import annotations

import numpy as np
import torch

def invert3x3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 float64 matrix (its closed-form path)."""
    m = np.asarray(m, np.float64)
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
         (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
         (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
         (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


# columns per step of OpenCV's vector warp loop (its AVX2 build: two
# registers of eight float32 lanes)
VECTOR_COLUMNS = 16


def _fma(a, b, c):
    """float32 a*b + c with one rounding (via float64)."""
    return (a.double() * b.double() + c.double()).float()


def _gather(pad, iy, ix):
    """The texture (padded by one) at integer (iy, ix), the pad outside."""
    Hp, Wp = pad.shape[:2]
    return pad[(iy + 1).clamp(0, Hp - 1), (ix + 1).clamp(0, Wp - 1)]


def _source_xy(M, size, device):
    """Each destination pixel's source coordinate (float32 x, y).  OpenCV's
    vector loop takes ``VECTOR_COLUMNS`` columns a step; the columns left
    over go through its scalar loop, where the compiler fuses
    ``x*M0 + y*M1 + M2`` into ``fma(x, M0, y*M1) + M2``."""
    H, W = size
    Mf = torch.as_tensor(M, dtype=torch.float64, device=device).float()
    y = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    body = W - W % VECTOR_COLUMNS
    xb, xt = x[:, :body], x[:, body:]
    lin = []
    for r in range(3):
        row = y * Mf[r, 1] + Mf[r, 2]
        tail = _fma(xt, Mf[r, 0], (y * Mf[r, 1]).expand(H, W - body))
        lin.append(torch.cat([_fma(xb, Mf[r, 0], row).expand(H, body),
                              tail + Mf[r, 2]], dim=1))
    return lin[0] / lin[2], lin[1] / lin[2]


def _index(v, n):
    """Integer texture index, clamped into the one-pixel border."""
    return v.clamp(-2, n + 1).long()


def _warp_linear(pad, sx, sy):
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = _index(fx, pad.shape[1] - 2), _index(fy, pad.shape[0] - 2)
    p00, p01 = _gather(pad, iy, ix), _gather(pad, iy, ix + 1)
    p10, p11 = _gather(pad, iy + 1, ix), _gather(pad, iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    v = _fma(b, v1 - v0, v0)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def _nearest_inside(sx, sy, tex_hw):
    """Where INTER_NEAREST lands inside a tex_hw texture."""
    X, Y = torch.round(sx), torch.round(sy)
    return (X >= 0) & (X < tex_hw[1]) & (Y >= 0) & (Y < tex_hw[0])


def _padded(tex, device, border: int = 0):
    """An HxWxC texture as float32 on ``device``, padded by one pixel of
    ``border``."""
    t = torch.as_tensor(np.ascontiguousarray(tex), device=device)
    t = t.reshape(t.shape[0], t.shape[1], -1)
    pad = torch.full((t.shape[0] + 2, t.shape[1] + 2, t.shape[2]),
                     float(border), dtype=torch.float32, device=device)
    pad[1:-1, 1:-1] = t
    return pad


def warp_perspective(src: np.ndarray, Hm: np.ndarray, size,
                     nearest: bool = False, device="cpu",
                     border: int = 0) -> np.ndarray:
    """``cv2.warpPerspective(src, Hm, (W, H), flags=INTER_LINEAR or
    INTER_NEAREST, borderValue=border)`` with ``BORDER_CONSTANT``, for a
    uint8 image, computed on ``device``."""
    pad = _padded(src, device, border)
    sx, sy = _source_xy(invert3x3(Hm), size, device)
    if nearest:
        X = _index(torch.round(sx), pad.shape[1] - 2)
        Y = _index(torch.round(sy), pad.shape[0] - 2)
        out = _gather(pad, Y, X).to(torch.uint8)
    else:
        out = _warp_linear(pad, sx, sy)
    return out.reshape(tuple(size) + src.shape[2:]).cpu().numpy()


class RealTextureScene:
    """Textured multi-plane scene with exact ground-truth camera poses.

    ``planes``: list of (texture [Ht,Wt,3] u8, A, ex, ey) — the world
    rectangle X(s,t) = A + s*ex + t*ey, s in [0,Wt), t in [0,Ht), rendered
    far-to-near (painter's order as given).
    """

    def __init__(self, planes, K, rotations, translations,
                 image_size=(1080, 1920)):
        self.planes = planes
        self.K = np.asarray(K, np.float64)
        self.rotations = np.asarray(rotations, np.float64)
        self.translations = np.asarray(translations, np.float64)
        self.image_size = image_size

    @property
    def n_frames(self) -> int:
        return len(self.rotations)

    def centers(self) -> np.ndarray:
        R = self.rotations
        t = self.translations
        return np.einsum("nij,nj->ni", R.transpose(0, 2, 1), -t)

    def render(self, i: int, device="cpu") -> np.ndarray:
        """Frame ``i`` as HxWx3 uint8 RGB, the warps computed on
        ``device``."""
        size = tuple(self.image_size)
        R, t = self.rotations[i], self.translations[i]
        frame = torch.zeros(size + (3,), dtype=torch.uint8, device=device)
        for tex, A, ex, ey in self.planes:
            # homography (s, t, 1) -> pixel: K [R ex | R ey | R A + t]
            Hm = self.K @ np.column_stack([R @ ex, R @ ey, R @ A + t])
            sx, sy = _source_xy(invert3x3(Hm), size, device)
            warped = _warp_linear(_padded(tex, device), sx, sy)
            # the mask: an all-255 texture warped INTER_NEAREST is > 0
            # exactly where the nearest source pixel lies inside
            inside = _nearest_inside(sx, sy, tex.shape[:2])
            frame[inside] = warped[inside]
        return frame.cpu().numpy()


def make_two_plane_scene(textures, n_frames: int = 24, step: float = 0.12,
                         image_size=(1080, 1920)):
    """A lateral-tracking camera over two textured walls at different
    depths (genuine parallax).  ``textures``: two RGB uint8 images.

    The far wall spans the whole sweep at depth 6; the near wall tiles a
    band at depth 3.5 across the lower half — both stay in view throughout
    so tracks persist and the essential bootstrap sees two depths."""
    H, W = image_size
    fx = fy = 0.9 * W
    K = np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1.0]])

    sweep = step * (n_frames - 1)
    t_far, t_near = textures[0], textures[1]
    planes = []
    # far wall: depth 6, width covering the FOV plus the sweep
    d_far = 6.0
    half_w = d_far * (W / 2.0) / fx
    x0, x1 = -half_w, half_w + sweep
    half_h = d_far * (H / 2.0) / fy
    Ht, Wt = t_far.shape[:2]
    planes.append((
        t_far,
        np.array([x0, -half_h, d_far]),
        np.array([(x1 - x0) / Wt, 0, 0]),
        np.array([0, 2.0 * half_h / Ht, 0]),
    ))
    # near band: depth 3.5, lower half of the view
    d_near = 3.5
    half_wn = d_near * (W / 2.0) / fx
    xn0, xn1 = -half_wn, half_wn + sweep
    y_top = 0.1 * d_near * (H / 2.0) / fy
    y_bot = d_near * (H / 2.0) / fy
    Hn, Wn = t_near.shape[:2]
    planes.append((
        t_near,
        np.array([xn0, y_top, d_near]),
        np.array([(xn1 - xn0) / Wn, 0, 0]),
        np.array([0, (y_bot - y_top) / Hn, 0]),
    ))

    rotations = np.tile(np.eye(3), (n_frames, 1, 1))
    centers = np.zeros((n_frames, 3))
    centers[:, 0] = step * np.arange(n_frames)
    translations = np.einsum("nij,nj->ni", rotations, -centers)
    return RealTextureScene(planes, K, rotations, translations, image_size)


def procedural_texture(shape, seed: int) -> np.ndarray:
    """An RGB uint8 texture from ``seed`` (no photo): multi-octave smoothed
    noise (six octaves of random grids of 32, 16, ... 2 px cells, bilinearly
    enlarged, each at 0.7 times the amplitude of the one before), quantized
    to six levels per channel so that it has the edges and corners of a
    photo (smoothed noise alone gives FAST nothing to detect)."""
    cell, octaves, levels = 32, 6, 6
    H, W = shape
    rng = np.random.default_rng(seed)
    acc = np.zeros((H, W, 3))
    amp = 1.0
    for o in range(octaves):
        c = max(2, cell >> o)
        grid = rng.random((H // c + 2, W // c + 2, 3))
        ys, xs = np.arange(H) / c, np.arange(W) / c
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        top = (1 - fx) * grid[y0][:, x0] + fx * grid[y0][:, x0 + 1]
        bottom = (1 - fx) * grid[y0 + 1][:, x0] + fx * grid[y0 + 1][:, x0 + 1]
        acc += amp * ((1 - fy) * top + fy * bottom)
        amp *= 0.7
    acc = (acc - acc.min()) / max(acc.max() - acc.min(), 1e-12)
    steps = np.minimum(np.floor(acc * levels), levels - 1) / (levels - 1)
    return np.round(255 * steps).astype(np.uint8)
