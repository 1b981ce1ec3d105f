"""Whole-slide image reading, QC, and tile extraction into tfrecords.

The port's copy of ``biscuit_tpu/data/slide.py`` (the stand-in for
slideflow's libvips/cuCIM slide stack; reference call sites
configure.py:115-133, results.py:235-248).

Reader backends (dispatch in ``WSI.__init__`` below): tiled TIFF/BigTIFF
— which covers Aperio ``.svs`` including the JPEG2000-compressed
(33003/33005) majority of the real TCGA/CPTAC corpus — reads through the
port's native region reader (``data/native_loader.py`` ``TiledTiff``:
libtiff regions + dlopen'd OpenJPEG), PIL-free and bounded-memory on
multi-gigapixel slides. A container that ``TiledTiff`` rejects at open
(striped TIFF; JPEG2000 without OpenJPEG), PNG and JPEG are read through
PIL, as in the JAX package. A native library that fails to build or load
raises: it is not a rejection by the format.

QC follows the reference semantics of ``qc='both'`` (configure.py:118-124):
* Otsu threshold on the slide thumbnail's grayscale -> tissue mask; a tile
  must cover enough tissue.
* Blur filter: variance-of-Laplacian on the tile; out-of-focus/background
  tiles drop below threshold.

Grid geometry matches slideflow: tiles of ``tile_um`` microns at the
slide's MPP, resized to ``tile_px`` pixels, on a stride of extraction
size / ``stride_div``.
"""

from __future__ import annotations

import os
from os.path import basename, join, splitext
from typing import Iterator, Optional

import numpy as np

from ..utils_log import log

DEFAULT_MPP = 1.0  # assumed microns-per-pixel when the file has no metadata
BLUR_THRESHOLD = 15.0
TISSUE_FRACTION = 0.25


def load_roi_csv(path: str):
    """Load slideflow-style ROI polygons: CSV with columns
    ``roi_name`` (or ``ROI_Name``), ``x_base``, ``y_base`` — one vertex per
    row, grouped by name, in level-0 pixel coordinates."""
    import pandas as pd

    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    name_col = cols.get("roi_name", cols.get("name"))
    x_col = cols.get("x_base", cols.get("x"))
    y_col = cols.get("y_base", cols.get("y"))
    if x_col is None or y_col is None:
        raise ValueError(f"Unrecognized ROI CSV columns in {path}")
    polys = []
    groups = df.groupby(name_col) if name_col else [(0, df)]
    for _, g in groups:
        poly = np.stack(
            [g[x_col].to_numpy(float), g[y_col].to_numpy(float)], axis=1
        )
        if len(poly) >= 3:
            polys.append(poly)
    return polys


def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon test.

    Args:
        points: (N, 2) xy coordinates.
        poly: (M, 2) polygon vertices.
    """
    x, y = points[:, 0, None], points[:, 1, None]
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(poly[:, 0], -1), np.roll(poly[:, 1], -1)
    crosses = ((y1 <= y) & (y < y2)) | ((y2 <= y) & (y < y1))
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = x1 + (y - y1) * (x2 - x1) / np.where(y2 == y1, np.inf,
                                                     y2 - y1)
    hits = crosses & (x < x_int)
    return hits.sum(axis=1) % 2 == 1


def otsu_threshold(gray: np.ndarray) -> float:
    """Otsu's method on a uint8 grayscale array."""
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    total = gray.size
    sum_all = (np.arange(256) * hist).sum()
    sum_b = 0.0
    w_b = 0.0
    best_var, best_t = -1.0, 127
    for t in range(256):
        w_b += hist[t]
        if w_b == 0:
            continue
        w_f = total - w_b
        if w_f == 0:
            break
        sum_b += t * hist[t]
        m_b = sum_b / w_b
        m_f = (sum_all - sum_b) / w_f
        var_between = w_b * w_f * (m_b - m_f) ** 2
        if var_between > best_var:
            best_var, best_t = var_between, t
    return float(best_t)


def laplacian_variance(gray: np.ndarray) -> float:
    """Variance of the 4-neighbor Laplacian (focus/blur metric)."""
    g = gray.astype(np.float32)
    lap = (
        -4 * g[1:-1, 1:-1]
        + g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
    )
    return float(lap.var())


class WSI:
    """Whole-slide image with a tile grid (stand-in for sf.WSI,
    results.py:235-248)."""

    def __init__(
        self,
        path: str,
        tile_px: int,
        tile_um: int,
        mpp: Optional[float] = None,
        roi_method: str = "ignore",
        stride_div: int = 1,
        qc: Optional[str] = None,
        rois: Optional[list] = None,
    ):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        self.path = path
        self.name = splitext(basename(path))[0]
        self.tile_px = tile_px
        self.tile_um = tile_um
        self.roi_method = roi_method
        # Tiled-TIFF containers (.svs, pyramidal TIFF) route pixel access
        # through the native libtiff region reader so extraction memory is
        # bounded by a tile, not the slide (PIL decodes the whole image on
        # first pixel access — multi-GB for real WSIs). JPEG2000 (Aperio
        # 33003/33005) decodes natively via OpenJPEG; striped files fall
        # back to PIL.
        self._tiled = None
        self._levels = []  # [(w, h)] per TIFF directory, fetched once
        if splitext(path)[1].lower() in (".svs", ".tif", ".tiff"):
            from .native_loader import TiledTiff

            try:
                self._tiled = TiledTiff(path)
            except OSError:  # rejected by its format: PIL reads it
                self._tiled = None
            else:
                try:
                    self._levels = TiledTiff.levels(path)
                except OSError:
                    self._levels = []
        # PIL handle for metadata (and striped-file pixel fallback). J2K
        # .svs files are unopenable by PIL entirely — the native reader is
        # then the only path and metadata comes from bn_tiff_description.
        try:
            self._img = Image.open(path)  # lazy: metadata unless decoded
        except Exception:
            if self._tiled is None:
                raise
            self._img = None
        if self._img is not None:
            self.width, self.height = self._img.size
        else:
            self.width, self.height = self._tiled.width, self._tiled.height
        self.mpp = mpp if mpp is not None else self._detect_mpp()
        # Extraction size at level 0 and stride.
        self.extract_px = max(1, int(round(tile_um / self.mpp)))
        self.stride = max(1, self.extract_px // stride_div)
        # Pyramid shortcut (openslide best_level_for_downsample semantics):
        # when the extraction window is downsampled to tile_px anyway, read
        # from the deepest pyramid level whose downsample still
        # oversamples the target — 4-16x less tile decode on real .svs.
        self._read_level = None
        self._level_ds = 1.0
        if self._tiled is not None and self.extract_px > self.tile_px:
            self._pick_read_level()
        self.grid_x = max(0, (self.width - self.extract_px) // self.stride + 1)
        self.grid_y = max(0, (self.height - self.extract_px) // self.stride + 1)
        self.qc = qc
        self._tissue_mask = None
        # ROI handling (configure.py:70-76 plumbing): `rois` may be polygon
        # arrays or a path to a slideflow-style ROI CSV. roi_method:
        # 'inside' keeps tiles whose centers fall in any ROI, 'outside'
        # the complement, 'ignore'/'auto' disables ROI filtering.
        if isinstance(rois, str):
            rois = load_roi_csv(rois)
        self.rois = rois
        if qc in ("otsu", "both"):
            self._compute_tissue_mask()

    def close(self):
        """Release native TIFF handles (and the PIL handle); safe to call
        repeatedly. Long extraction loops close each slide explicitly
        rather than relying on GC timing for file handles."""
        for attr in ("_tiled", "_read_level"):
            h = getattr(self, attr, None)
            if h is not None:
                h.close()
                setattr(self, attr, None)
        img = getattr(self, "_img", None)
        if img is not None and hasattr(img, "close"):
            img.close()

    def _pyramid_levels(self):
        """Aspect-checked pyramid levels as (index, w, h, downsample),
        skipping the .svs label/macro directories."""
        out = []
        for i, (w, h) in enumerate(self._levels[1:], start=1):
            if not w or not h:
                continue
            if abs((w / h) - (self.width / self.height)) > 0.05:
                continue
            out.append((i, w, h, self.width / w))
        return out

    def _pick_read_level(self):
        from .native_loader import TiledTiff

        want_ds = self.extract_px / self.tile_px
        best = None
        for i, w, h, ds in self._pyramid_levels():
            if ds <= want_ds and (best is None or ds > best[3]):
                best = (i, w, h, ds)
        if best is not None and best[3] > 1.0:
            try:
                self._read_level = TiledTiff(self.path, level=best[0])
                self._level_ds = best[3]
            except OSError:
                self._read_level = None
                self._level_ds = 1.0

    def _detect_mpp(self) -> float:
        """MPP from Aperio ImageDescription ('|MPP = 0.25|', tag 270) or
        TIFF resolution tags when present, else DEFAULT_MPP. When PIL
        cannot open the container (J2K .svs), the description comes from
        the native reader."""
        try:
            if self._img is not None and hasattr(self._img, "tag_v2"):
                info = dict(self._img.tag_v2)
            else:
                from .native_loader import TiledTiff

                info = {270: TiledTiff.description(self.path) or ""}
            desc = info.get(270, "")
            if isinstance(desc, bytes):
                desc = desc.decode(errors="ignore")
            if desc and "MPP" in desc:
                for part in str(desc).replace("\n", "|").split("|"):
                    if "MPP" in part and "=" in part:
                        try:
                            mpp = float(part.split("=")[1].strip())
                        except ValueError:
                            continue  # malformed; try tags below
                        # Only accept plausible values: 'MPP = 0' would
                        # otherwise crash extract_px with a zero division,
                        # and slide scanners are all within 0.1-10 um/px.
                        if 0.0 < mpp < 10.0:
                            return mpp
            # XResolution tag 282 in pixels per resolution unit (2=inch, 3=cm)
            xres = info.get(282)
            unit = info.get(296, 2)
            if xres:
                xres = float(xres)
                if unit == 3:  # px/cm -> um/px
                    return 10000.0 / xres
                return 25400.0 / xres
        except Exception:
            pass
        return DEFAULT_MPP

    def _compute_tissue_mask(self):
        if self._tiled is not None:
            # TiledTiff.thumbnail internally reads from the smallest
            # pyramid level that still meets 1024px.
            rgb = self._tiled.thumbnail(max_px=1024).astype(np.float32)
            # ITU-R 601 luma, matching PIL convert("L").
            gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                    + 0.114 * rgb[..., 2]).astype(np.uint8)
        else:
            thumb_scale = max(1, max(self.width, self.height) // 1024)
            thumb = self._img.resize(
                (max(1, self.width // thumb_scale),
                 max(1, self.height // thumb_scale))
            ).convert("L")
            gray = np.asarray(thumb)
        t = otsu_threshold(gray)
        # Tissue is darker than background on brightfield H&E. Otsu's t is
        # the INCLUSIVE upper bound of the dark class ([0..t] vs [t+1..255],
        # the cv2 THRESH_OTSU convention), so the dark-class test is <=.
        self._tissue_mask = gray <= t
        # Derive the mask scale from the mask's actual shape — recomputing
        # the downsample independently desynchronizes when the thumbnail
        # came from a pyramid level (compound scale).
        self._thumb_scale = self.width / gray.shape[1]

    def _tile_is_tissue(self, x: int, y: int) -> bool:
        if self._tissue_mask is None:
            return True
        s = self._thumb_scale  # float: mask px per slide px
        mx0, my0 = int(x / s), int(y / s)
        mx1 = max(mx0 + 1, int((x + self.extract_px) / s))
        my1 = max(my0 + 1, int((y + self.extract_px) / s))
        region = self._tissue_mask[my0:my1, mx0:mx1]
        return region.size > 0 and region.mean() >= TISSUE_FRACTION

    def coords(self):
        """Grid coordinates as (grid_i, grid_j, x, y), ROI-filtered when a
        ROI list is present and roi_method is 'inside'/'outside'."""
        out = []
        for j in range(self.grid_y):
            for i in range(self.grid_x):
                out.append((i, j, i * self.stride, j * self.stride))
        if self.rois and self.roi_method in ("inside", "outside"):
            centers = np.asarray(
                [(x + self.extract_px / 2, y + self.extract_px / 2)
                 for _, _, x, y in out]
            )
            inside = np.zeros(len(out), bool)
            for poly in self.rois:
                inside |= points_in_polygon(centers, np.asarray(poly))
            keep = inside if self.roi_method == "inside" else ~inside
            out = [c for c, k in zip(out, keep) if k]
        return out

    def read_tile(self, x: int, y: int) -> np.ndarray:
        """Extract one tile at level-0 (x, y), resized to tile_px."""
        from PIL import Image

        if self._read_level is not None:
            ds = self._level_ds
            lv = self._read_level
            lpx = max(1, min(int(round(self.extract_px / ds)),
                             lv.width, lv.height))
            # Clamp so non-integer downsamples can't read past the level
            # edge (zero-filled black stripes on border tiles); worst-case
            # misregistration vs the base path is ~ds/2 slide pixels.
            lx = max(0, min(int(round(x / ds)), lv.width - lpx))
            ly = max(0, min(int(round(y / ds)), lv.height - lpx))
            region = Image.fromarray(lv.read_region(lx, ly, lpx, lpx))
        elif self._tiled is not None:
            region = Image.fromarray(
                self._tiled.read_region(x, y, self.extract_px,
                                        self.extract_px))
        else:
            region = self._img.crop(
                (x, y, x + self.extract_px, y + self.extract_px)
            ).convert("RGB")
        if region.size != (self.tile_px, self.tile_px):
            region = region.resize(
                (self.tile_px, self.tile_px), Image.BILINEAR
            )
        return np.asarray(region)

    def build_generator(self, shuffle: bool = False,
                        include_loc: str = "grid",
                        seed: int = 0) -> Iterator[dict]:
        """Tile generator (sf.WSI.build_generator contract,
        results.py:240-248): yields {'image': HWC uint8, 'loc': (i, j)}."""
        coords = self.coords()
        if shuffle:
            rng = np.random.default_rng(seed)
            coords = [coords[i] for i in rng.permutation(len(coords))]

        def generator():
            for i, j, x, y in coords:
                if self.qc in ("otsu", "both") and not self._tile_is_tissue(x, y):
                    continue
                img = self.read_tile(x, y)
                if self.qc in ("blur", "both"):
                    gray = np.asarray(img, np.float32).mean(axis=-1)
                    if laplacian_variance(gray.astype(np.uint8)) < BLUR_THRESHOLD:
                        continue
                item = {"image": img}
                if include_loc == "grid":
                    item["loc"] = (i, j)
                else:
                    item["loc"] = (x, y)
                yield item

        return generator

    def extract_tiles(self, tfrecord_path: str, img_format: str = "png",
                      shuffle: bool = False) -> int:
        """Extract all QC-passing tiles into a tfrecord; returns count.
        Loads the native library first, so the records' CRC32C runs there
        (``data/tfrecord.py``)."""
        import io

        from PIL import Image

        from .native_loader import load
        from .tfrecord import TFRecordWriter

        load()
        n = 0
        with TFRecordWriter(tfrecord_path) as w:
            for item in self.build_generator(shuffle=shuffle)():
                buf = io.BytesIO()
                Image.fromarray(item["image"]).save(
                    buf, format=img_format.upper()
                )
                w.write_tile(
                    self.name, buf.getvalue(),
                    loc_x=item["loc"][0], loc_y=item["loc"][1],
                )
                n += 1
        return n


def _write_pdf_report(project, report, tile_px, tile_um, tfr_paths,
                      samples_per_slide=8):
    """PDF tile-extraction report (slideflow's extract_tiles writes a PDF
    report the reference relies on for QC review; configure.py:115-133).
    Page 1: per-slide summary table; then one page per slide with sample
    tile thumbnails read back from its tfrecord."""
    import io as _io

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from PIL import Image

    from .tfrecord import load_index, read_example_at

    path = join(project.root,
                f"tile_extraction_report_{tile_px}px_{tile_um}um.pdf")
    rows_per_page = 40
    with PdfPages(path) as pdf:
        cells = [[r["slide"], str(r["tiles"]), r["grid"], r["source"]]
                 for r in report]
        for p0 in range(0, len(cells), rows_per_page):
            fig, ax = plt.subplots(figsize=(8.5, 11))
            ax.axis("off")
            ax.set_title(
                f"Tile extraction report — {tile_px}px / {tile_um}um\n"
                f"project: {project.name} "
                f"(slides {p0 + 1}-{min(p0 + rows_per_page, len(cells))}"
                f" of {len(cells)})", fontsize=12,
            )
            table = ax.table(
                cellText=cells[p0:p0 + rows_per_page],
                colLabels=["slide", "tiles", "grid", "source"],
                loc="upper center", cellLoc="left",
            )
            table.auto_set_font_size(False)
            table.set_fontsize(8)
            pdf.savefig(fig)
            plt.close(fig)

        for r in report:
            tfr = tfr_paths.get(r["slide"])
            if not tfr or not os.path.exists(tfr):
                continue
            offsets = load_index(tfr)[:samples_per_slide]
            imgs = []
            with open(tfr, "rb") as f:
                for off in offsets:
                    ex = read_example_at(f, int(off))
                    try:
                        imgs.append(np.asarray(
                            Image.open(_io.BytesIO(ex["image_raw"]))))
                    except Exception:
                        continue
            if not imgs:
                continue
            cols = min(4, len(imgs))
            rows_n = -(-len(imgs) // cols)
            fig, axes = plt.subplots(
                rows_n, cols, figsize=(8.5, 2.2 * rows_n + 0.6))
            axes = np.atleast_1d(axes).ravel()
            for ax_i, img in zip(axes, imgs):
                ax_i.imshow(img)
            for ax_i in axes:
                ax_i.axis("off")
            fig.suptitle(f"{r['slide']} — {r['tiles']} tiles "
                         f"(grid {r['grid']})", fontsize=10)
            pdf.savefig(fig)
            plt.close(fig)
    return path


def extract_tiles_for_project(project, tile_px=299, tile_um=302, qc=None,
                              img_format="png", source=None,
                              report_pdf=True, **kwargs):
    """Extract tiles for every annotated slide with a registered slide file
    (sf.Project.extract_tiles contract, configure.py:115-133). Writes
    per-slide tfrecords under `tfrecords/{tile_px}px_{tile_um}um/`, an
    extraction report CSV, and (like slideflow) a PDF report with sample
    tile thumbnails per slide (report_pdf=False to skip)."""
    import pandas as pd

    report = []
    tfr_paths = {}
    sources = [source] if source else project.sources
    for src in sources:
        try:
            cfg = project.source_config(src)
        except (FileNotFoundError, KeyError):
            continue
        slides_dir = cfg.get("slides", "")
        tfr_root = cfg.get("tfrecords", "")
        if not slides_dir or not os.path.isdir(slides_dir):
            log.debug(f"Source {src}: no slides directory; skipping")
            continue
        out_dir = join(tfr_root, f"{tile_px}px_{tile_um}um")
        os.makedirs(out_dir, exist_ok=True)
        annotated = set(project.dataset(verification=None).slides())
        for fname in sorted(os.listdir(slides_dir)):
            name, ext = splitext(fname)
            if ext.lower() not in (".svs", ".tif", ".tiff", ".png", ".jpg",
                                   ".jpeg"):
                continue
            if annotated and name not in annotated:
                continue
            out_path = join(out_dir, f"{name}.tfrecords")
            if os.path.exists(out_path):
                log.debug(f"{name}: tfrecord exists; skipping")
                continue
            roi_dir = cfg.get("roi", "")
            roi_csv = join(roi_dir, f"{name}.csv") if roi_dir else ""
            roi_kw = {}
            if roi_csv and os.path.exists(roi_csv):
                roi_kw = {"rois": roi_csv, "roi_method": "inside"}
            wsi = WSI(join(slides_dir, fname), tile_px, tile_um, qc=qc,
                      **roi_kw, **kwargs)
            try:
                n = wsi.extract_tiles(out_path, img_format=img_format)
            finally:
                wsi.close()
            report.append({"slide": name, "tiles": n, "source": src,
                           "grid": f"{wsi.grid_x}x{wsi.grid_y}"})
            tfr_paths[name] = out_path
            log.info(f"Extracted {n} tiles from {name}")
    if report:
        pd.DataFrame(report).to_csv(
            join(project.root, f"extraction_report_{tile_px}px.csv"),
            index=False,
        )
        if report_pdf:
            try:
                pdf = _write_pdf_report(project, report, tile_px, tile_um,
                                        tfr_paths)
                log.info(f"Wrote extraction report {pdf}")
            except Exception as e:  # report must never sink extraction
                log.warning(f"PDF extraction report failed: {e}")
    return report
