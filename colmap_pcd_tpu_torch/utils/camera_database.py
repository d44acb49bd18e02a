"""Camera specs database + EXIF focal-length priors.

Re-implements base/camera_database.{h,cc} (QuerySensorWidth with the same
make/model normalization and substring-matching semantics) and the EXIF
focal-length derivation of util/bitmap.cc:300-400 (ExifFocalLength: 35mm
equivalent first, then focal-in-mm over the sensor width from the database,
then the focal-plane-resolution fallback), using PIL for EXIF access.

The reference ships a generated ~3k-entry specs table (util/camera_specs.cc);
here a curated table of common sensor families covers the frequent cases and
`load_extra_specs` lets deployments feed a full CSV (make,model,width_mm) —
the lookup semantics are identical.
"""

from __future__ import annotations

import os
import re

# make -> {cleaned model -> sensor width in mm}. Curated from public sensor
# format specs (full-frame 36.0, APS-C 23.5/22.3, 4/3" 17.3, 1" 13.2,
# 1/1.7" 7.6, 1/2.3" 6.17, 1/2.5" 5.76, 1/3" 4.8, m4/3 phones etc.).
_SPECS: dict[str, dict[str, float]] = {
    "canon": {
        "eos5dmarkii": 36.0, "eos5dmarkiii": 36.0, "eos5dmarkiv": 36.0,
        "eos5d": 35.8, "eos6d": 35.8, "eos6dmarkii": 35.9, "eosr": 36.0,
        "eosr5": 36.0, "eosr6": 35.9, "eos1dxmarkii": 35.9, "eos1dxmarkiii": 35.9,
        "eos7d": 22.3, "eos7dmarkii": 22.4, "eos70d": 22.5, "eos80d": 22.3,
        "eos90d": 22.3, "eos60d": 22.3, "eos50d": 22.3, "eos40d": 22.2,
        "eos1100d": 22.2, "eos1200d": 22.3, "eos1300d": 22.3,
        "eos100d": 22.3, "eos200d": 22.3, "eos250d": 22.3,
        "eos550d": 22.3, "eos600d": 22.3, "eos650d": 22.3, "eos700d": 22.3,
        "eos750d": 22.3, "eos760d": 22.3, "eos800d": 22.3,
        "eosrebelt2i": 22.3, "eosrebelt3i": 22.3, "eosrebelt4i": 22.3,
        "eosrebelt5i": 22.3, "eosrebelt6i": 22.3, "eosrebelt7i": 22.3,
        "eosm": 22.3, "eosm50": 22.3, "eosm6": 22.3,
        "powershotg7x": 13.2, "powershotg9x": 13.2, "powershotg5x": 13.2,
        "powershotg12": 7.6, "powershotg15": 7.44, "powershotg16": 7.44,
        "powershots100": 7.6, "powershots110": 7.6, "powershots120": 7.6,
        "powershotsx260hs": 6.17, "powershotsx280hs": 6.17,
        "powershota2300": 6.17, "powershotelph": 6.17,
    },
    "nikon": {
        "d3": 36.0, "d3s": 36.0, "d3x": 35.9, "d4": 36.0, "d4s": 36.0,
        "d5": 35.8, "d6": 35.9, "d600": 35.9, "d610": 35.9, "d700": 36.0,
        "d750": 35.9, "d780": 35.9, "d800": 35.9, "d810": 35.9, "d850": 35.9,
        "df": 36.0, "z5": 35.9, "z6": 35.9, "z7": 35.9, "z9": 35.9,
        "d40": 23.7, "d50": 23.7, "d60": 23.6, "d70": 23.7, "d80": 23.6,
        "d90": 23.6, "d300": 23.6, "d300s": 23.6, "d500": 23.5,
        "d3000": 23.6, "d3100": 23.1, "d3200": 23.2, "d3300": 23.5,
        "d3400": 23.5, "d3500": 23.5, "d5000": 23.6, "d5100": 23.6,
        "d5200": 23.5, "d5300": 23.5, "d5500": 23.5, "d5600": 23.5,
        "d7000": 23.6, "d7100": 23.5, "d7200": 23.5, "d7500": 23.5,
        "z50": 23.5, "coolpixp7000": 7.6, "coolpixp7700": 7.44,
        "coolpixa": 23.6, "coolpixs9100": 6.17, "coolpixl820": 6.17,
    },
    "sony": {
        "ilce7": 35.8, "ilce7m2": 35.8, "ilce7m3": 35.6, "ilce7m4": 35.9,
        "ilce7r": 35.9, "ilce7rm2": 35.9, "ilce7rm3": 35.9, "ilce7rm4": 35.7,
        "ilce7s": 35.6, "ilce9": 35.6, "ilce1": 35.9,
        "ilce5000": 23.2, "ilce5100": 23.5, "ilce6000": 23.5,
        "ilce6100": 23.5, "ilce6300": 23.5, "ilce6400": 23.5,
        "ilce6500": 23.5, "ilce6600": 23.5,
        "nex3": 23.4, "nex5": 23.4, "nex5n": 23.4, "nex5r": 23.4,
        "nex6": 23.5, "nex7": 23.5,
        "dscrx100": 13.2, "dscrx100m2": 13.2, "dscrx100m3": 13.2,
        "dscrx100m4": 13.2, "dscrx100m5": 13.2, "dscrx100m6": 13.2,
        "dscrx100m7": 13.2, "dscrx10": 13.2, "dscrx1": 35.8,
        "dschx9v": 6.17, "dscwx350": 6.17, "dschx90v": 6.17,
    },
    "fujifilm": {
        "xt1": 23.6, "xt2": 23.6, "xt3": 23.5, "xt4": 23.5,
        "xt10": 23.6, "xt20": 23.6, "xt30": 23.5,
        "xpro1": 23.6, "xpro2": 23.6, "xpro3": 23.5,
        "xe1": 23.6, "xe2": 23.6, "xe3": 23.6, "xe4": 23.5,
        "xs10": 23.5, "xh1": 23.5, "x100": 23.6, "x100s": 23.6,
        "x100t": 23.6, "x100f": 23.6, "x100v": 23.5,
        "finepixs9900w": 6.17, "finepixhs50exr": 6.4, "finepixf900exr": 6.4,
        "gfx50s": 43.8, "gfx100": 43.8,
    },
    "olympus": {
        "em1": 17.3, "em1markii": 17.4, "em1markiii": 17.4,
        "em5": 17.3, "em5markii": 17.3, "em5markiii": 17.4,
        "em10": 17.3, "em10markii": 17.3, "em10markiii": 17.4,
        "penf": 17.3, "epl5": 17.3, "epl6": 17.3, "epl7": 17.3,
        "epl8": 17.3, "epl9": 17.4, "epm2": 17.3,
        "tg4": 6.17, "tg5": 6.17, "tg6": 6.17, "xz2": 7.6,
    },
    "panasonic": {
        "dmcgh3": 17.3, "dmcgh4": 17.3, "dcgh5": 17.3, "dcgh5s": 19.2,
        "dmcg7": 17.3, "dmcg80": 17.3, "dmcg85": 17.3, "dcg9": 17.3,
        "dmcgx7": 17.3, "dmcgx8": 17.3, "dmcgx80": 17.3, "dmcgx85": 17.3,
        "dmclx100": 17.3, "dclx100m2": 17.3, "dmclx10": 13.2, "dmclx15": 13.2,
        "dmcfz1000": 13.2, "dcfz1000m2": 13.2, "dmcfz300": 6.17,
        "dmctz70": 6.17, "dmctz80": 6.17, "dmctz100": 13.2,
    },
    "samsung": {
        "nx1": 23.5, "nx30": 23.5, "nx300": 23.5, "nx500": 23.5,
        "nx1000": 23.5, "nx2000": 23.5, "nx3000": 23.5,
        "galaxys7": 5.76, "galaxys8": 5.645, "galaxys9": 5.645,
        "galaxys10": 5.76, "galaxys20": 9.5, "galaxys21": 9.5,
        "galaxynote8": 5.645, "galaxynote9": 5.76, "galaxynote10": 5.76,
    },
    "apple": {
        "iphone4": 4.54, "iphone4s": 4.54, "iphone5": 4.54, "iphone5c": 4.54,
        "iphone5s": 4.8, "iphone6": 4.8, "iphone6plus": 4.8,
        "iphone6s": 4.8, "iphone6splus": 4.8, "iphonese": 4.8,
        "iphone7": 4.8, "iphone7plus": 4.8, "iphone8": 4.8,
        "iphone8plus": 4.8, "iphonex": 5.66, "iphonexr": 5.66,
        "iphonexs": 5.66, "iphone11": 5.66, "iphone11pro": 5.66,
        "iphone12": 5.76, "iphone12pro": 5.76, "iphone13": 7.01,
        "iphone13pro": 7.01, "iphone14": 7.01, "iphone15": 9.8,
    },
    "google": {
        "pixel": 6.17, "pixel2": 6.17, "pixel3": 6.17, "pixel4": 6.17,
        "pixel5": 6.17, "pixel6": 9.8, "pixel7": 9.8, "pixel8": 9.8,
    },
    "dji": {
        "fc300x": 6.17, "fc300s": 6.17, "fc330": 6.17,  # phantom 3/4
        "fc550": 17.3, "fc6310": 13.2, "fc6520": 17.3,  # inspire / p4pro
        "fc7203": 6.17, "fc3170": 6.4, "fc3411": 13.2,  # mavic mini/air/air2s
        "l1d20c": 13.2, "fc220": 6.17, "fc2103": 6.17,  # mavic pro/air
    },
    "gopro": {
        "hero3": 6.17, "hero4": 6.17, "hero5": 6.17, "hero6": 6.17,
        "hero7": 6.17, "hero8": 6.17, "hero9": 6.9, "hero10": 6.9,
    },
    "ricoh": {"gr": 23.7, "grii": 23.7, "griii": 23.5, "thetas": 6.17},
    "pentax": {"k5": 23.7, "k3": 23.5, "k70": 23.5, "k1": 35.9, "kp": 23.5},
    "leica": {"q": 36.0, "q2": 36.0, "m9": 35.8, "m10": 35.8, "sl": 36.0},
    "sigma": {"dp1": 20.7, "dp2": 20.7, "fp": 35.9},
    "hasselblad": {"x1d": 43.8, "l1d20c": 13.2},
}

_EXTRA: dict[str, dict[str, float]] = {}


def _clean(s: str) -> str:
    return re.sub(r"[\s\-]+", "", s or "").lower()


def _load_shipped_specs():
    """Load the full shipped specs table (camera_specs_data.csv, ~3.7k rows —
    the same public sensor-width constants the reference generates into
    util/camera_specs.cc; reference coverage without a deployment CSV)."""
    path = os.path.join(os.path.dirname(__file__), "camera_specs_data.csv")
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != 3:
                    continue
                try:
                    w = float(parts[2])
                except ValueError:
                    continue
                _EXTRA.setdefault(_clean(parts[0]), {}).setdefault(
                    _clean(parts[1]), w
                )
    except OSError:
        pass


_load_shipped_specs()


def load_extra_specs(csv_path: str) -> int:
    """Load additional `make,model,sensor_width_mm` rows (deployment-scale
    tables, e.g. a conversion of the reference's full specs list)."""
    n = 0
    with open(csv_path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 3:
                continue
            try:
                w = float(parts[2])
            except ValueError:
                continue
            _EXTRA.setdefault(_clean(parts[0]), {})[_clean(parts[1])] = w
            n += 1
    return n


def query_sensor_width(make: str, model: str) -> float | None:
    """Sensor width in mm, or None (camera_database.cc:43-90 semantics:
    bidirectional substring matching on cleaned make/model; an exact model
    match wins; more than one fuzzy match is ambiguous -> None)."""
    cmake = _clean(make)
    cmodel = _clean(model).replace(cmake, "")
    if not cmake or not cmodel:
        return None
    # merge the shipped + curated + deployment tables per (make, model) so a
    # model present in several tables counts as ONE candidate (the ambiguity
    # rule below must mirror the reference's single-table semantics); later
    # tables override earlier ones
    merged: dict[tuple[str, str], float] = {}
    for table in (_EXTRA, _SPECS):
        for mk, models in table.items():
            if mk in cmake or cmake in mk:
                for md, width in models.items():
                    merged[(mk, md)] = width
    matches = []
    for (_mk, md), width in merged.items():
        if md in cmodel or cmodel in md:
            if cmodel == md:
                return width
            matches.append(width)
    return matches[0] if len(matches) == 1 else None


def exif_focal_length(path: str, width: int, height: int) -> float | None:
    """Focal length in pixels from EXIF, or None (bitmap.cc ExifFocalLength):
    1. FocalLengthIn35mmFilm: f35/35 * max_size
    2. FocalLength (mm) + database sensor width: f/sensor * max_size
    3. FocalLength + FocalPlane{XResolution,ResolutionUnit}: derived sensor
    """
    try:
        from PIL import ExifTags, Image

        with Image.open(path) as im:
            exif = im.getexif()
            if not exif:
                return None
            ifd = exif.get_ifd(ExifTags.IFD.Exif) if hasattr(ExifTags, "IFD") else {}
    except Exception:
        return None

    max_size = float(max(width, height))

    def as_float(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            m = re.search(r"([0-9.]+)", str(v))
            return float(m.group(1)) if m else None

    f35 = as_float(ifd.get(41989))  # FocalLengthIn35mmFilm
    if f35 and f35 > 0:
        return f35 / 35.0 * max_size
    fmm = as_float(ifd.get(37386))  # FocalLength
    if fmm and fmm > 0:
        make = exif.get(271)
        model = exif.get(272)
        if make and model:
            sw = query_sensor_width(str(make), str(model))
            if sw:
                return fmm / sw * max_size
        # focal-plane resolution fallback
        pxd = as_float(ifd.get(40962))  # PixelXDimension
        xres = as_float(ifd.get(41486))  # FocalPlaneXResolution
        unit = ifd.get(41488)  # FocalPlaneResolutionUnit: 2=inch, 3=cm
        if pxd and xres and xres > 0 and unit in (2, 3):
            ccd_width = pxd / xres
            mm_per_unit = 25.4 if unit == 2 else 10.0
            if ccd_width > 0:
                return fmm / (ccd_width * mm_per_unit) * max_size
    return None
