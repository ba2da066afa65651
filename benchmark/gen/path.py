"""The sensor's path: planar segments driven at a constant speed, with a
start ramp, a vertical bob and a roll/pitch sway, all vectorised over time.

One layout, named by the traffic file's ``path.kind``: ``staircase``,
straights of seeded lengths joined by 90-degree turns that go left and
right in turn, so the path runs on diagonally and never comes back.

A turn of length ``turn_len`` eases in and out: its heading follows
``3 u^2 - 2 u^3`` of the way ``u`` through it, so the curvature (and the
yaw rate and the lateral acceleration) rises from 0 and falls back to 0
as a vehicle's or a walker's does, peaking at ``1.5 (pi / 2) / turn_len``.
Heading and curvature are closed-form in the arc length ``s``; the
position within a turn comes from one table of the unit turn's integral.
``s(t)`` rises as ``v t^2 / (2 T)`` over the ramp ``T`` and as
``v (t - T / 2)`` after it, and stays 0 before ``t = 0`` (the IMU's static
calibration). The IMU's rates and specific force come from the analytic
derivatives, not from differences.
"""

from __future__ import annotations

import numpy as np

GRAVITY = 9.80665


def rot_zyx(yaw, pitch, roll) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll), (n, 3, 3)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    R = np.empty(np.shape(yaw) + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


_U = np.linspace(0.0, 1.0, 20001)
_PSI = 0.5 * np.pi * (3 * _U ** 2 - 2 * _U ** 3)
_dU = np.diff(_U)
# the unit left turn's position, by the trapezoid rule (error ~1e-9 of L)
_TX = np.r_[0.0, np.cumsum(0.5 * (np.cos(_PSI[1:]) + np.cos(_PSI[:-1]))
                           * _dU)]
_TY = np.r_[0.0, np.cumsum(0.5 * (np.sin(_PSI[1:]) + np.sin(_PSI[:-1]))
                           * _dU)]


class Path:
    """``params``: the traffic file's ``path`` object; ``seed``: the run's
    seed (the staircase's segment lengths and first turn)."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.v = float(params["speed"])
        self.ramp = float(params["ramp_s"])
        self.kind = params["kind"]
        self.turn_len = float(params["turn_len"])
        self._rng = np.random.default_rng([seed, 1])
        # segment table: start s, start x, y, heading, length, turn (+1
        # left, -1 right, 0 straight)
        self._s0, self._x0, self._y0, self._h0 = [], [], [], []
        self._len, self._turn_of = [], []
        if self.kind != "staircase":
            raise ValueError(f"path kind {self.kind!r}")
        self._turn = 1.0 if self._rng.random() < 0.5 else -1.0
        self._extend(1.0)
        self._arrays()

    # ------------------------------------------------------------ segments
    def _add(self, length: float, turn: float) -> None:
        if self._s0:
            k = len(self._s0) - 1
            x, y, h, _ = self._at(np.array([k]), np.array([self._len[k]]))
            s, x, y, h = self._s0[k] + self._len[k], x[0], y[0], h[0]
        else:
            s, x, y, h = 0.0, 0.0, 0.0, 0.0
        self._s0.append(s)
        self._x0.append(x)
        self._y0.append(y)
        self._h0.append(h)
        self._len.append(length)
        self._turn_of.append(turn)
        self._arrays()

    def _extend(self, s_max: float) -> None:
        lo, hi = self.p["straight"]
        while not self._s0 or self._s0[-1] + self._len[-1] < s_max:
            self._add(float(self._rng.uniform(lo, hi)), 0.0)
            self._add(self.turn_len, self._turn)
            self._turn = -self._turn

    def _arrays(self) -> None:
        self.seg_s0 = np.asarray(self._s0)
        self.seg_x0 = np.asarray(self._x0)
        self.seg_y0 = np.asarray(self._y0)
        self.seg_h0 = np.asarray(self._h0)
        self.seg_len = np.asarray(self._len)
        self.seg_turn = np.asarray(self._turn_of)

    def ensure(self, s_max: float) -> None:
        """Make the segment table reach arc length ``s_max``."""
        if self._s0[-1] + self._len[-1] < s_max:
            self._extend(s_max)

    def _at(self, k, ds):
        """(x, y, heading, curvature) at ``ds`` into segments ``k``."""
        x0, y0, h0 = self.seg_x0[k], self.seg_y0[k], self.seg_h0[k]
        L, sg = self.seg_len[k], self.seg_turn[k]
        u = np.clip(ds / L, 0.0, 1.0)
        tx, ty = np.interp(u, _U, _TX) * L, sg * np.interp(u, _U, _TY) * L
        ch, sh = np.cos(h0), np.sin(h0)
        straight = sg == 0.0
        x = np.where(straight, x0 + ds * ch, x0 + ch * tx - sh * ty)
        y = np.where(straight, y0 + ds * sh, y0 + sh * tx + ch * ty)
        h = h0 + sg * 0.5 * np.pi * (3 * u ** 2 - 2 * u ** 3)
        kap = sg * 0.5 * np.pi * 6 * u * (1 - u) / L
        return x, y, h, kap

    def planar(self, s):
        """(x, y, heading, curvature) at arc lengths ``s``."""
        s = np.asarray(s, np.float64)
        self.ensure(float(np.max(s, initial=0.0)) + 1.0)
        k = np.clip(np.searchsorted(self.seg_s0, s, side="right") - 1, 0,
                    len(self.seg_s0) - 1)
        return self._at(k, s - self.seg_s0[k])

    # -------------------------------------------------------------- timing
    def s_of_t(self, t):
        """(s, ds/dt, d2s/dt2) at times ``t``."""
        t = np.asarray(t, np.float64)
        v, T = self.v, self.ramp
        tc = np.clip(t, 0.0, None)
        in_ramp = tc < T
        s = np.where(in_ramp, v * tc * tc / (2 * T), v * (tc - T / 2))
        sd = np.where(in_ramp, v * tc / T, v)
        sdd = np.where(in_ramp & (t > 0), v / T, 0.0)
        return s, sd, sdd

    def _wave(self, name, s, sd, sdd):
        """A sinusoid of ``s`` (amplitude, wavelength [m], phase) and its
        first two time derivatives."""
        amp, lam, ph = self.p.get(name, (0.0, 1.0, 0.0))
        k = 2 * np.pi / lam
        arg = k * s + ph
        f = amp * np.sin(arg)
        fd = amp * k * np.cos(arg) * sd
        fdd = (-amp * k * k * np.sin(arg) * sd * sd
               + amp * k * np.cos(arg) * sdd)
        return f, fd, fdd

    # ---------------------------------------------------------------- pose
    def pose(self, t):
        """Ground-truth sensor pose at times ``t``: (R (n, 3, 3), p (n, 3))
        in the world frame; a point ``w`` is seen at ``R^T (w - p)``."""
        s, sd, sdd = self.s_of_t(t)
        x, y, h, _ = self.planar(s)
        z, _, _ = self._wave("bob", s, sd, sdd)
        pitch, _, _ = self._wave("pitch", s, sd, sdd)
        roll, _, _ = self._wave("roll", s, sd, sdd)
        R = rot_zyx(h, pitch, roll)
        p = np.stack([x, y, z + float(self.p.get("height", 0.0))], axis=-1)
        return R, p

    def imu(self, t):
        """(gyro (n, 3) rad/s, specific force (n, 3) m/s^2) in the sensor
        frame at times ``t``: body rates of the ZYX angles and
        ``R^T (a + g e_z)``."""
        s, sd, sdd = self.s_of_t(t)
        _, _, h, kap = self.planar(s)
        _, zd, zdd = self._wave("bob", s, sd, sdd)
        th, thd, _ = self._wave("pitch", s, sd, sdd)
        ph, phd, _ = self._wave("roll", s, sd, sdd)
        hd = kap * sd
        gyro = np.stack([
            phd - hd * np.sin(th),
            thd * np.cos(ph) + hd * np.cos(th) * np.sin(ph),
            -thd * np.sin(ph) + hd * np.cos(th) * np.cos(ph)], axis=-1)
        ch, sh = np.cos(h), np.sin(h)
        acc = np.stack([sdd * ch - sd * sd * kap * sh,
                        sdd * sh + sd * sd * kap * ch,
                        zdd + GRAVITY], axis=-1)
        R = rot_zyx(h, th, ph)
        return gyro, np.einsum("nji,nj->ni", R, acc)
