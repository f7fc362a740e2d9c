"""TUM trajectory files (counterpart of ``dsopp_tpu/output/tum.py``, a
numpy copy of it): one line a pose, ``timestamp tx ty tz qx qy qz qw`` (the
file's quaternion is x, y, z, w; the internal order w, x, y, z)."""

from __future__ import annotations

import numpy as np


def _matrix_to_quat(m):
    """3x3 rotation → (w, x, y, z), Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diagonal(m)))
    if i == 0:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s,
             (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif i == 1:
        s = np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
             0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    return np.asarray(q)


def _quat_to_matrix(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def export_tum(path, entries):
    """Write [(timestamp, T_wc 4x4 ndarray)] to a TUM file."""
    with open(path, "w") as f:
        for ts, mat in entries:
            mat = np.asarray(mat)
            q = _matrix_to_quat(mat[:3, :3])
            t = mat[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def load_tum(path):
    """Read a TUM file → [(timestamp, T_wc 4x4 ndarray)]."""
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            ts = float(parts[0])
            tx, ty, tz, qx, qy, qz, qw = [float(v) for v in parts[1:8]]
            mat = np.eye(4)
            mat[:3, :3] = _quat_to_matrix(qw, qx, qy, qz)
            mat[:3, 3] = [tx, ty, tz]
            entries.append((ts, mat))
    return entries
