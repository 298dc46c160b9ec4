"""Constant-velocity Kalman filter in numpy (a copy of the JAX package's
utils/kalman.py, which the port may not import).

The tracker's motion model: state = [x1,y1,x2,y2, vx1,vy1,vx2,vy2],
F = identity + dt coupling, H observes the 4 positions, and the noise
covariances Q and R are supplied per call (DeepSORT-style, scaled by the
box's extent).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["KalmanFilter"]


class KalmanFilter:
    def __init__(self, dim_x: int = 8, dim_z: int = 4):
        self.dim_x = dim_x
        self.dim_z = dim_z
        self.x = np.zeros(dim_x)
        self.P = np.eye(dim_x)
        self.F = np.eye(dim_x)
        self.H = np.eye(dim_z, dim_x)
        self.Q = np.eye(dim_x)
        self.R = np.eye(dim_z)

    def predict(self, Q: Optional[np.ndarray] = None):
        Q = self.Q if Q is None else Q
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + Q

    def update(self, z: np.ndarray, R: Optional[np.ndarray] = None):
        R = self.R if R is None else R
        y = np.asarray(z, float) - self.H @ self.x
        S = self.H @ self.P @ self.H.T + R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        ikh = np.eye(self.dim_x) - K @ self.H
        # Joseph form for numerical stability
        self.P = ikh @ self.P @ ikh.T + K @ R @ K.T
