"""VGG preprocessing constants: the RGB means that ``train.normalize_images``
subtracts on the device.  The host-side decode and resize of the JAX
package's ``data/preprocessing.py`` are not ported yet."""

from __future__ import annotations

R_MEAN, G_MEAN, B_MEAN = 123.68, 116.78, 103.94
