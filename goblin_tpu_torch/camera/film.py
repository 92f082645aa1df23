"""Film: reconstruction filter, accumulation buffers, dense and scatter
splats and image output (port of goblin_tpu/camera/film.py).

Filters are evaluated in closed form, with the reference's normalisation
semantics (src/GoblinFilter.cpp, GoblinFilm.cpp:10-37). The output takes
the reference's post-process in its order, bloom then tone mapping, and is
written as EXR or as an 8-bit PPM (any other name gets ".ppm").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..io import exr as exr_io

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"


@dataclass(frozen=True)
class FilterSpec:
    kind: str = FILTER_GAUSSIAN
    x_width: float = 1.0
    y_width: float = 1.0
    falloff: float = 2.0  # gaussian
    b: float = 2.0  # mitchell
    c: float = 2.0  # mitchell

    def normalize_term(self) -> float:
        """The filter's integral (reference getNormalizeTerm of each
        filter), which a splat with normalized=True divides by."""
        if self.kind == FILTER_BOX:
            return 4.0 * self.x_width * self.y_width
        if self.kind == FILTER_TRIANGLE:
            return self.x_width ** 2 * self.y_width ** 2
        if self.kind == FILTER_GAUSSIAN:
            # the reference's numeric approximation on a 20 x 20 grid
            # (src/GoblinFilter.cpp:48-63)
            step = 20
            dx = self.x_width / step
            dy = self.y_width / step
            ex = np.exp(-self.falloff * self.x_width ** 2)
            ey = np.exp(-self.falloff * self.y_width ** 2)
            xs = np.arange(step) * dx
            ys = np.arange(step) * dy
            gx = np.maximum(0.0, np.exp(-self.falloff * xs ** 2) - ex)
            gy = np.maximum(0.0, np.exp(-self.falloff * ys ** 2) - ey)
            return float(4.0 * dx * dy * np.outer(gy, gx).sum())
        if self.kind == FILTER_MITCHELL:
            # separable: the 1D filter in pixel units is M(2 x / width), so
            # an axis integrates to width * (I0 + I1), the integrals of the
            # Mitchell polynomial's pieces over [0, 1] and [1, 2]
            # (goblin_tpu's value, not the reference's mixed sum)
            b, c = self.b, self.c
            i0 = ((12 - 9 * b - 6 * c) / 4 + (-18 + 12 * b + 6 * c) / 3
                  + (6 - 2 * b)) / 6.0
            i1 = (15 * (-b - 6 * c) / 4 + 7 * (6 * b + 30 * c) / 3
                  + 3 * (-12 * b - 48 * c) / 2 + (8 * b + 24 * c)) / 6.0
            return float(self.x_width * self.y_width * (i0 + i1) ** 2)
        raise ValueError(self.kind)

    def evaluate(self, dx, dy):
        """Unnormalised filter value at offsets (broadcastable tensors)."""
        if self.kind == FILTER_BOX:
            return torch.ones_like(dx)
        if self.kind == FILTER_TRIANGLE:
            return (torch.clamp(self.x_width - dx.abs(), min=0.0)
                    * torch.clamp(self.y_width - dy.abs(), min=0.0))
        if self.kind == FILTER_GAUSSIAN:
            ex = float(np.exp(-self.falloff * self.x_width ** 2))
            ey = float(np.exp(-self.falloff * self.y_width ** 2))
            gx = torch.clamp(torch.exp(-self.falloff * dx * dx) - ex, min=0.0)
            gy = torch.clamp(torch.exp(-self.falloff * dy * dy) - ey, min=0.0)
            return gx * gy
        if self.kind == FILTER_MITCHELL:
            return (self._mitchell_1d(dx / self.x_width)
                    * self._mitchell_1d(dy / self.y_width))
        raise ValueError(self.kind)

    def _mitchell_1d(self, x):
        b, c = self.b, self.c
        x = (2.0 * x).abs()
        inner = ((12 - 9 * b - 6 * c) * x ** 3
                 + (-18 + 12 * b + 6 * c) * x ** 2 + (6 - 2 * b)) / 6.0
        outer = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
                 + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
        return torch.where(x > 1.0, outer, inner)


@dataclass(frozen=True)
class FilmSpec:
    x_res: int = 512
    y_res: int = 512
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "goblin.exr"
    tone_mapping: bool = False
    bloom_radius: float = 0.0
    bloom_weight: float = 0.0
    filter: FilterSpec = field(default_factory=FilterSpec)

    @property
    def aspect_ratio(self) -> float:
        return self.x_res / self.y_res

    def crop_window(self):
        """(x_start, x_count, y_start, y_count) like the reference Film."""
        xs = int(np.ceil(self.x_res * self.crop[0]))
        xc = max(1, int(np.ceil(self.x_res * self.crop[1])) - xs)
        ys = int(np.ceil(self.y_res * self.crop[2]))
        yc = max(1, int(np.ceil(self.y_res * self.crop[3])) - ys)
        return xs, xc, ys, yc

    def sample_range(self):
        """(x_start, x_end, y_start, y_end) of the continuous sample
        positions that reach the crop window: the window widened by the
        filter (reference Film::getSampleRange)."""
        xs, xc, ys, yc = self.crop_window()
        fw, fh = self.filter.x_width, self.filter.y_width
        return (int(np.floor(xs + 0.5 - fw)), int(np.floor(xs + 0.5 + xc + fw)),
                int(np.floor(ys + 0.5 - fh)), int(np.floor(ys + 0.5 + yc + fh)))


def new_film(spec: FilmSpec, device):
    """-> (color (H, W, 3), weight (H, W)) zeroed on device."""
    return (
        torch.zeros((spec.y_res, spec.x_res, 3), dtype=torch.float32,
                    device=device),
        torch.zeros((spec.y_res, spec.x_res), dtype=torch.float32,
                    device=device),
    )


def splat_taps(spec: FilmSpec, x, y, L, normalized=False):
    """Filter taps of samples at continuous image coords x, y (R,) with
    radiance L (R, 3) -> (flat pixel index, w, w * L) over each sample's
    static window of candidate pixels. Taps outside the filter or the film,
    and non-finite samples, get weight 0 (and radiance 0). normalized
    divides the weights by the filter's integral, for the integrators that
    resolve the film without its weights (the light tracer)."""
    f = spec.filter
    dx_img = x - 0.5
    dy_img = y - 0.5
    nan_ok = torch.isfinite(L).all(dim=-1) & torch.isfinite(x) & torch.isfinite(y)
    kx = int(np.floor(2 * f.x_width)) + 1
    ky = int(np.floor(2 * f.y_width)) + 1
    x0 = torch.ceil(dx_img - f.x_width).to(torch.int32)
    y0 = torch.ceil(dy_img - f.y_width).to(torch.int32)
    gy, gx = torch.meshgrid(torch.arange(ky, device=x.device),
                            torch.arange(kx, device=x.device), indexing="ij")
    px = x0[:, None, None] + gx[None]  # (R, ky, kx)
    py = y0[:, None, None] + gy[None]
    fdx = px.to(torch.float32) - dx_img[:, None, None]
    fdy = py.to(torch.float32) - dy_img[:, None, None]
    w = f.evaluate(fdx, fdy)
    inside = ((fdx.abs() <= f.x_width) & (fdy.abs() <= f.y_width)
              & (px >= 0) & (px < spec.x_res) & (py >= 0) & (py < spec.y_res)
              & nan_ok[:, None, None])
    w = torch.where(inside, w, 0.0)
    if normalized:
        w = w / f.normalize_term()
    # a weight of 0 times a non-finite sample is still NaN: zero L first
    L = torch.where(nan_ok[:, None], L, 0.0)
    # a zero tap adds nothing wherever it lands: spread them over the film,
    # so that the taps of samples sent off the film (-1e9) do not all add
    # into one pixel, one atomic after another
    n_pix = spec.x_res * spec.y_res
    spread = torch.arange(px.numel(), device=x.device).reshape(px.shape) % n_pix
    flat_idx = torch.where(inside, py * spec.x_res + px, spread).reshape(-1)
    return flat_idx, w.reshape(-1), (w[..., None] * L[:, None, None, :]
                                     ).reshape(-1, 3)


def splat_accum(color, weight, flat_idx, w_flat, wL):
    """Scatter-add the taps of splat_taps into the film, in place."""
    color.view(-1, 3).index_add_(0, flat_idx.long(), wL)
    weight.view(-1).index_add_(0, flat_idx.long(), w_flat)
    return color, weight


def splat(spec: FilmSpec, color, weight, x, y, L, normalized=False):
    """Filter-splat a batch of samples into the film (taps, then scatter);
    adds into color and weight in place and returns them."""
    return splat_accum(color, weight, *splat_taps(spec, x, y, L, normalized))


def splat_dense(spec: FilmSpec, color, weight, jx, jy, L, ys0=0, xs0=0):
    """Dense filter splat of one stratified sample per crop pixel.

    Pixel (iy, ix) sums w(0.5 - o - jitter) * L over the static window of
    neighbouring samples: shifted multiply-adds, no scatter. jx, jy:
    (yc, xc) jitters in [0, 1); L: (yc, xc, 3). Non-finite samples are
    dropped (reference ImageTile::addSample NaN guard). Adds into color
    and weight in place and returns them.
    """
    f = spec.filter
    yc, xc = jx.shape
    kx = int(np.floor(f.x_width + 0.5))
    ky = int(np.floor(f.y_width + 0.5))
    fin = torch.isfinite(L).all(dim=-1)
    Lz = torch.where(fin[..., None], L, 0.0)
    pad = (kx, kx, ky, ky)
    Lp = F.pad(Lz.permute(2, 0, 1), pad).permute(1, 2, 0)
    jxp = F.pad(jx, pad)
    jyp = F.pad(jy, pad)
    finp = F.pad(fin.to(torch.float32), pad)
    acc_c = torch.zeros((yc, xc, 3), dtype=torch.float32, device=L.device)
    acc_w = torch.zeros((yc, xc), dtype=torch.float32, device=L.device)
    for oy in range(-ky, ky + 1):
        for ox in range(-kx, kx + 1):
            # sample of pixel (iy+oy, ix+ox) seen from target (iy, ix)
            sl = (slice(ky + oy, ky + oy + yc), slice(kx + ox, kx + ox + xc))
            fdx = 0.5 - ox - jxp[sl]
            fdy = 0.5 - oy - jyp[sl]
            w = f.evaluate(fdx, fdy)
            w = torch.where(
                (fdx.abs() <= f.x_width) & (fdy.abs() <= f.y_width),
                w * finp[sl], 0.0,
            )
            acc_c = acc_c + w[..., None] * Lp[sl]
            acc_w = acc_w + w
    color[ys0:ys0 + yc, xs0:xs0 + xc] += acc_c
    weight[ys0:ys0 + yc, xs0:xs0 + xc] += acc_w
    return color, weight


def to_image(color, weight, normalize: bool = True):
    """Resolve the accumulation to an image (reference Film::writeImage):
    the colour over the weights, or as it is with normalize=False."""
    if normalize:
        return color / torch.clamp(weight, min=1e-30)[..., None]
    return color


def luminance(rgb):
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def tone_map(img):
    """Reinhard's photographic tone mapping as the reference implements it,
    its log(1e4 + y) world adaptation included
    (src/GoblinImageIO.cpp:223-237)."""
    y = luminance(img)
    ywa = float(torch.exp(torch.log(1e4 + y).mean()))
    inv_y2 = 1.0 / (ywa * ywa)
    s = (1.0 + y * inv_y2) / (1.0 + y)
    return img * s[..., None]


def bloom(img, radius: float, weight: float):
    """The reference's bloom (src/GoblinImageIO.cpp:169-219): each pixel
    blended with the (1 - d / fw)^4 weighted mean of its neighbours within
    fw = ceil(radius max(W, H)) // 2 pixels, the pixel itself left out, the
    mean normalised by the weight that lies on the image. Both
    convolutions go through torch.fft in float64 (numpy's precision in
    goblin_tpu), zero-padded, on img's device."""
    if radius <= 0.0 or weight <= 0.0:
        return img
    h, w = img.shape[:2]
    fw = int(np.ceil(radius * max(w, h))) // 2
    if fw < 1:
        return img
    f64 = torch.float64
    k = torch.arange(-fw + 1, fw, dtype=f64, device=img.device)
    d = torch.sqrt(k[None, :] * k[None, :] + k[:, None] * k[:, None]) / fw
    kern = torch.clamp(1.0 - d, min=0.0) ** 4
    kern[fw - 1, fw - 1] = 0.0
    size = (h + kern.shape[0] - 1, w + kern.shape[1] - 1)
    K = torch.fft.rfft2(kern, s=size)

    def conv(x):
        full = torch.fft.irfft2(torch.fft.rfft2(x, s=size) * K, s=size)
        return full[..., fw - 1:fw - 1 + h, fw - 1:fw - 1 + w]

    norm = conv(torch.ones((h, w), dtype=f64, device=img.device))
    out = conv(img.permute(2, 0, 1).to(f64)).permute(1, 2, 0)
    out = (out / torch.clamp(norm, min=1e-12)[..., None]).to(torch.float32)
    return (1.0 - weight) * img + weight * out


def write_image(spec: FilmSpec, image) -> str:
    """Post-process the image as the film asks (bloom, then tone mapping)
    and write it to spec.filename: EXR for a name ending in .exr, else an
    8-bit PPM (".ppm" appended to a name without it). Returns the path."""
    img = image.detach().to(torch.float32)
    if spec.bloom_radius > 0.0 and spec.bloom_weight > 0.0:
        img = bloom(img, spec.bloom_radius, spec.bloom_weight)
    if spec.tone_mapping:
        img = tone_map(img)
    img = img.cpu().numpy()
    path = spec.filename
    if path.endswith(".exr"):
        exr_io.write_exr(path, img)
        return path
    if not path.endswith(".ppm"):
        path = path + ".ppm"
    exr_io.write_ppm(path, img)
    return path
