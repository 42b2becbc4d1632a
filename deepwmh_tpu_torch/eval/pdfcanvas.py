"""Vector-PDF canvas and matrix plotting, from scratch (the port's copy of
``deepwmh_tpu.eval.pdfcanvas``; the same bytes for the same drawing).

A minimal PDF 1.4 writer (one page, uncompressed content stream, the 14
standard Type1 fonts, FlateDecode RGB image XObjects, ExtGState alpha)
behind the reference's PlotCanvas drawing API (text / line / rect /
image), plus ``plot_mat``, a colormapped matrix on ``eval.colormaps``. No
time is stamped into the file.

Units: positions and page sizes accept "5cm, 3.4cm", "4mm, 1mm", "2in, 1in"
strings or (x, y) tuples in cm; 72 points per inch.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from deepwmh_tpu_torch.eval.colormaps import apply_colormap

PT_PER_INCH = 72.0
PT_PER_CM = PT_PER_INCH / 2.54
PT_PER_MM = PT_PER_CM / 10.0

STANDARD_FONTS = (
    "Helvetica", "Helvetica-Bold", "Helvetica-Oblique", "Helvetica-BoldOblique",
    "Times-Roman", "Times-Bold", "Times-Italic", "Times-BoldItalic",
    "Courier", "Courier-Bold", "Courier-Oblique", "Courier-BoldOblique",
    "Symbol", "ZapfDingbats",
)


def parse_unit(s) -> float:
    """'5mm' / '2cm' / '1in' / bare number (cm) -> PDF points."""
    if isinstance(s, (int, float)):
        return float(s) * PT_PER_CM
    s = s.strip()
    if "mm" in s:
        return float(s.replace("mm", "").strip()) * PT_PER_MM
    if "cm" in s:
        return float(s.replace("cm", "").strip()) * PT_PER_CM
    if "inch" in s or "in" in s:
        return float(s.replace("inch", "").replace("in", "").strip()) * PT_PER_INCH
    return float(s) * PT_PER_CM


def parse_position(s):
    """'5cm, 3.4cm' or (x_cm, y_cm) -> (x_pt, y_pt)."""
    if isinstance(s, str):
        a, b = s.split(",")
        return parse_unit(a), parse_unit(b)
    if isinstance(s, (tuple, list)) and len(s) == 2:
        return s[0] * PT_PER_CM, s[1] * PT_PER_CM
    raise ValueError("unknown position: %r" % (s,))


def _esc(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def _load_image_rgb(path):
    """Read an image file to a uint8 RGB array (matplotlib's PNG reader)."""
    import matplotlib.image as mpimg

    img = mpimg.imread(path)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


class PdfCanvas:
    """Single-page vector PDF canvas with the reference PlotCanvas API
    (text / line / rect / image / save). Coordinates are PDF-style:
    origin at the bottom-left, y grows upward."""

    def __init__(self, output_file: str = "output.pdf",
                 pagesize: str = "21.0cm*29.7cm"):
        self.output_file = output_file
        w, h = pagesize.split("*")
        self.page_w, self.page_h = parse_unit(w), parse_unit(h)
        self._ops = []           # content stream operators
        self._fonts = {}         # base font name -> /F id
        self._font_alias = {}    # register_font aliases -> standard font
        self._images = []        # (width, height, zlib rgb bytes)
        self._gstates = {}       # (stroke_alpha, fill_alpha) -> /GS id

    # -- drawing ---------------------------------------------------------

    def _alpha_op(self, alpha, stroke_alpha=None):
        # /ca = fill alpha, /CA = stroke alpha (PDF 1.4 ExtGState)
        key = (
            round(float(alpha if stroke_alpha is None else stroke_alpha), 3),
            round(float(alpha), 3),
        )
        if key not in self._gstates:
            self._gstates[key] = "GS%d" % len(self._gstates)
        return "/%s gs" % self._gstates[key]

    def register_font(self, font_file, font_name):
        """TTF embedding is out of scope for the minimal writer: the alias
        maps onto Helvetica so layouts keep working."""
        self._font_alias[font_name] = "Helvetica"

    def text(self, s, position, font_name, font_size, font_color=(0, 0, 0),
             alpha=1.0):
        x, y = parse_position(position)
        base = self._font_alias.get(font_name, font_name)
        if base not in STANDARD_FONTS:
            base = "Helvetica"
        if base not in self._fonts:
            self._fonts[base] = "F%d" % (len(self._fonts) + 1)
        r, g, b = font_color
        self._ops.append(
            "q %s BT /%s %g Tf %g %g %g rg %g %g Td (%s) Tj ET Q"
            % (self._alpha_op(alpha), self._fonts[base], font_size,
               r, g, b, x, y, _esc(str(s)))
        )

    def line(self, position_start, position_end, line_width,
             line_color=(0, 0, 0), alpha=1.0, dashed=False, dash_pattern=(3, 3)):
        xs, ys = parse_position(position_start)
        xe, ye = parse_position(position_end)
        r, g, b = line_color
        dash = "[%g %g] 0 d" % dash_pattern if dashed else "[] 0 d"
        self._ops.append(
            "q %s %g w %g %g %g RG %s %g %g m %g %g l S Q"
            % (self._alpha_op(alpha), line_width, r, g, b, dash, xs, ys, xe, ye)
        )

    def rect(self, position_start, position_end, line_width,
             line_color=(0, 0, 0), fill_color=(1, 1, 1),
             line_alpha=1.0, fill_alpha=1.0):
        xs, ys = parse_position(position_start)
        xe, ye = parse_position(position_end)
        parts = [
            "q",
            self._alpha_op(fill_alpha, stroke_alpha=line_alpha),
            "%g w" % line_width,
        ]
        if line_color is not None:
            parts.append("%g %g %g RG" % tuple(line_color))
        if fill_color is not None:
            parts.append("%g %g %g rg" % tuple(fill_color))
        parts.append("%g %g %g %g re" % (xs, ys, xe - xs, ye - ys))
        if line_color is not None and fill_color is not None:
            parts.append("B")
        elif fill_color is not None:
            parts.append("f")
        else:
            parts.append("S")
        parts.append("Q")
        self._ops.append(" ".join(parts))

    def image(self, position_start, position_end, image_path: str):
        if not os.path.isfile(image_path):
            raise FileNotFoundError(image_path)
        rgb = _load_image_rgb(image_path)
        h_px, w_px = rgb.shape[:2]
        xs, ys = parse_position(position_start)
        if position_end is not None:
            xe, ye = parse_position(position_end)
            w_pt, h_pt = xe - xs, ye - ys
        else:
            w_pt, h_pt = float(w_px), float(h_px)  # 1 point per pixel
        idx = len(self._images)
        self._images.append((w_px, h_px, zlib.compress(rgb.tobytes())))
        self._ops.append(
            "q %g 0 0 %g %g %g cm /Im%d Do Q" % (w_pt, h_pt, xs, ys, idx)
        )

    def image_array(self, position_start, position_end, rgb: np.ndarray):
        """Draw a uint8 RGB array directly (no file round-trip)."""
        rgb = np.ascontiguousarray(np.asarray(rgb, np.uint8)[..., :3])
        h_px, w_px = rgb.shape[:2]
        xs, ys = parse_position(position_start)
        xe, ye = parse_position(position_end)
        idx = len(self._images)
        self._images.append((w_px, h_px, zlib.compress(rgb.tobytes())))
        self._ops.append(
            "q %g 0 0 %g %g %g cm /Im%d Do Q"
            % (xe - xs, ye - ys, xs, ys, idx)
        )

    # -- serialization ----------------------------------------------------

    def save(self):
        out_dir = os.path.dirname(os.path.abspath(self.output_file))
        os.makedirs(out_dir, exist_ok=True)

        objects = []  # list of bytes, object number = index + 1

        def add(body: bytes) -> int:
            objects.append(body)
            return len(objects)

        content = "\n".join(self._ops).encode("latin-1")
        font_objs = {
            fid: add(
                b"<< /Type /Font /Subtype /Type1 /BaseFont /"
                + base.encode() + b" >>"
            )
            for base, fid in self._fonts.items()
        }
        image_objs = {}
        for i, (w_px, h_px, data) in enumerate(self._images):
            body = (
                b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
                b"/ColorSpace /DeviceRGB /BitsPerComponent 8 "
                b"/Filter /FlateDecode /Length %d >>\nstream\n"
                % (w_px, h_px, len(data))
            ) + data + b"\nendstream"
            image_objs["Im%d" % i] = add(body)
        gs_objs = {
            gid: add(b"<< /Type /ExtGState /CA %g /ca %g >>" % (ca, fa))
            for (ca, fa), gid in self._gstates.items()
        }
        content_obj = add(
            b"<< /Length %d >>\nstream\n" % len(content) + content
            + b"\nendstream"
        )

        res = []
        if font_objs:
            res.append(
                b"/Font << "
                + b" ".join(b"/%s %d 0 R" % (f.encode(), o) for f, o in font_objs.items())
                + b" >>"
            )
        if image_objs:
            res.append(
                b"/XObject << "
                + b" ".join(b"/%s %d 0 R" % (n.encode(), o) for n, o in image_objs.items())
                + b" >>"
            )
        if gs_objs:
            res.append(
                b"/ExtGState << "
                + b" ".join(b"/%s %d 0 R" % (g.encode(), o) for g, o in gs_objs.items())
                + b" >>"
            )
        page_obj = add(
            b"<< /Type /Page /Parent PAGES 0 R /MediaBox [0 0 %g %g] "
            b"/Contents %d 0 R /Resources << %s >> >>"
            % (self.page_w, self.page_h, content_obj, b" ".join(res))
        )
        pages_obj = add(
            b"<< /Type /Pages /Kids [%d 0 R] /Count 1 >>" % page_obj
        )
        objects[page_obj - 1] = objects[page_obj - 1].replace(
            b"PAGES", b"%d" % pages_obj
        )
        catalog_obj = add(b"<< /Type /Catalog /Pages %d 0 R >>" % pages_obj)

        buf = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(objects, start=1):
            offsets.append(len(buf))
            buf += b"%d 0 obj\n" % i + body + b"\nendobj\n"
        xref_at = len(buf)
        buf += b"xref\n0 %d\n" % (len(objects) + 1)
        buf += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            buf += b"%010d 00000 n \n" % off
        buf += (
            b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, catalog_obj, xref_at)
        )
        with open(self.output_file, "wb") as f:
            f.write(bytes(buf))


def plot_mat(m: np.ndarray, save_file: str = "mat.pdf",
             cmap: str = "grayscale", normalize_data: bool = True):
    """Colormapped matrix as one vector PDF (reference plot.py:240-263:
    0.5cm cells, row 0 at the top). The matrix is embedded as ONE RGB image
    XObject instead of rows*cols rect ops — identical rendering (PDF
    images are sampled per-cell), kilobytes instead of megabytes."""
    import warnings

    m = np.asarray(m, np.float64)
    if normalize_data:
        m = (m - m.min()) / (m.max() - m.min() + 1e-8)
    elif m.min() < -1e-5 or m.max() > 1 + 1e-6:
        warnings.warn(
            'Out-of-range values with normalize_data=False: expected [0,1], '
            'got [%f, %f].' % (m.min(), m.max())
        )
    rgb = apply_colormap(np.clip(m, 0, 1), cmap)
    rows, cols = m.shape
    cell = 0.5  # cm, the reference's blocksize
    cv = PdfCanvas(save_file, "%fcm*%fcm" % (cell * cols, cell * rows))
    cv.image_array((0, 0), (cell * cols, cell * rows), rgb)
    cv.save()
    return save_file


# reference-compatible alias (plot.py names the class PlotCanvas)
PlotCanvas = PdfCanvas
