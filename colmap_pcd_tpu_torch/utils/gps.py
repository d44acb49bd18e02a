"""GPS coordinate conversions: WGS84 lat/lon/alt -> ECEF -> local ENU.

Parity with src/base/gps.{h,cc} (GPSTransform): used by spatial matching with
GPS priors and model_aligner with geo-referenced images. A copy of
colmap_pcd_tpu/utils/gps.py (host code, carried).
"""

from __future__ import annotations

import numpy as np

_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


def lla_to_ecef(lat_deg, lon_deg, alt) -> np.ndarray:
    """[...,3] (lat°, lon°, alt m) -> ECEF meters."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt, np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    N = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * sl * sl)
    x = (N + alt) * cl * np.cos(lon)
    y = (N + alt) * cl * np.sin(lon)
    z = (N * (1.0 - _WGS84_E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_enu_rotation(lat0_deg: float, lon0_deg: float) -> np.ndarray:
    """Rotation taking ECEF directions to local east/north/up axes."""
    lat0 = np.deg2rad(lat0_deg)
    lon0 = np.deg2rad(lon0_deg)
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    return np.asarray(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


def ecef_to_enu(ecef: np.ndarray, lat0_deg: float, lon0_deg: float, alt0: float) -> np.ndarray:
    """ECEF -> local east/north/up relative to the given origin."""
    origin = lla_to_ecef(lat0_deg, lon0_deg, alt0)
    R = ecef_to_enu_rotation(lat0_deg, lon0_deg)
    return (np.asarray(ecef) - origin) @ R.T


def lla_to_enu(lat_deg, lon_deg, alt, lat0_deg, lon0_deg, alt0) -> np.ndarray:
    return ecef_to_enu(lla_to_ecef(lat_deg, lon_deg, alt), lat0_deg, lon0_deg, alt0)
