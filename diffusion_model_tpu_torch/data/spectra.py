"""EELS/ELNES spectrum ingestion: spline fit + resampling to 200 points.

Equivalent of ``fitted_intensity``/``fitted_intensity_wo_normalize``
(ref data_preparation.py:186-216): locate the ``O:ex`` K1 edge header in the
CASTEP coreloss output, min-max normalise, fit an interpolating spline and
resample on the fixed -1..19 eV grid with 0.1 eV spacing (200 points).

The port's own copy of ``diffusion_model_tpu/data/spectra.py`` (scipy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import InterpolatedUnivariateSpline

CORELOSS_HEADER = "#  O 1    K1      O:ex"
GRID = np.arange(-1.0, 19.0, 0.1)  # 200 points (ref data_preparation.py:198)


def find_line_number(path: str, target_text: str):
    """1-based line number containing ``target_text``
    (ref data_preparation.py:52-60)."""
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            if target_text in line:
                return i
    return None


def normalize_minmax(values: np.ndarray) -> np.ndarray:
    vmin, vmax = values.min(), values.max()
    return (values - vmin) / (vmax - vmin)


def fitted_intensity(path: str, normalize: bool = True,
                     header: str = CORELOSS_HEADER) -> np.ndarray:
    """200-point resampled intensity curve from a coreloss edge file."""
    skip = find_line_number(path, header)
    if skip is None:
        raise ValueError(f"header {header!r} not found in {path}")
    data = np.loadtxt(path, skiprows=skip).T
    wavelengths = np.asarray(data[0])
    intensities = np.asarray(data[1])
    if normalize:
        intensities = normalize_minmax(intensities)
    spline = InterpolatedUnivariateSpline(wavelengths, intensities)
    return spline(GRID)


def fitted_intensity_wo_normalize(path: str) -> np.ndarray:
    return fitted_intensity(path, normalize=False)
