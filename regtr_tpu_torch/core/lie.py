"""SO(3)/SE(3) Lie-group classes over numpy (the port's own copy of
regtr_tpu/core/lie.py; a CPU test holds the two equal).

An object API over the functional ops of core/se3_np: identity,
sample_uniform, sample_small, exp, log, inv, composition, transform, hat,
vee, from/as_matrix, as_quaternion, and the analytic Jacobians of SE3.
Poses are stored as (..., 3, 4) matrices, as everywhere in the port.
"""
from __future__ import annotations

import numpy as np

from ..benchmark.predator import rotmat_to_quat
from . import se3_np


class SO3:
    """Rotation group element(s), stored as (..., 3, 3) matrices."""

    def __init__(self, mat: np.ndarray):
        mat = np.asarray(mat, np.float32)
        assert mat.shape[-2:] == (3, 3), mat.shape
        self.data = mat

    # -- constructors --------------------------------------------------------
    @staticmethod
    def identity():
        return SO3(np.eye(3, dtype=np.float32))

    @staticmethod
    def from_matrix(mat, normalize: bool = False):
        mat = np.asarray(mat, np.float32)
        if normalize:
            u, _, vt = np.linalg.svd(mat)
            d = np.sign(np.linalg.det(u @ vt))
            vt = vt.copy()
            vt[..., 2, :] *= d[..., None] if np.ndim(d) else d
            mat = u @ vt
        return SO3(mat)

    @staticmethod
    def exp(omega):
        return SO3(se3_np.so3_exp(np.asarray(omega, np.float32)))

    @staticmethod
    def sample_uniform(rng=None):
        rng = rng or np.random
        state = rng if isinstance(rng, np.random.RandomState) else \
            np.random.RandomState(np.random.randint(2 ** 31))
        return SO3(se3_np.sample_uniform_rotation(state))

    @staticmethod
    def sample_small(std: float = 0.1, rng=None):
        """Axis uniform on S2, angle ~ N(0, (std*pi/sqrt(3))^2) — semantics of
        the reference's SO3.sample_small (lie/numpy/so3.py:31-38)."""
        state = rng if isinstance(rng, np.random.RandomState) else \
            np.random.RandomState(np.random.randint(2 ** 31))
        from ..data.transforms import sample_small_pose

        return SO3(sample_small_pose(state, std)[..., :3, :3])

    # -- ops ------------------------------------------------------------------
    @staticmethod
    def hat(omega):
        return se3_np.so3_hat(np.asarray(omega))

    @staticmethod
    def vee(mat):
        mat = np.asarray(mat)
        return np.stack(
            [mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0]], axis=-1
        )

    def log(self):
        r = self.data
        trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
        theta = np.arccos(np.clip(0.5 * (trace - 1.0), -1 + 1e-7, 1 - 1e-7))
        vee = SO3.vee(r - np.swapaxes(r, -1, -2))
        scale = np.where(theta < 1e-6, 0.5, theta / (2.0 * np.sin(theta)))
        return scale[..., None] * vee

    def inv(self):
        return SO3(np.swapaxes(self.data, -1, -2))

    def __mul__(self, other):
        if isinstance(other, SO3):
            return SO3(self.data @ other.data)
        return np.einsum("...ij,...nj->...ni", self.data, np.asarray(other))

    def transform(self, xyz):
        return self * xyz

    def as_matrix(self):
        return self.data

    def as_quaternion(self):
        return rotmat_to_quat(self.data)

    @property
    def shape(self):
        return self.data.shape[:-2]

    def __repr__(self):
        return f"SO3({self.data.shape})"


class SE3:
    """Rigid-transform group element(s), stored as (..., 3, 4) matrices."""

    def __init__(self, mat: np.ndarray):
        mat = np.asarray(mat, np.float32)
        assert mat.shape[-2:] in ((3, 4), (4, 4)), mat.shape
        self.data = mat[..., :3, :]

    @staticmethod
    def identity():
        return SE3(np.eye(3, 4, dtype=np.float32))

    @staticmethod
    def from_rt(rot, trans):
        rot = rot.data if isinstance(rot, SO3) else np.asarray(rot)
        return SE3(se3_np.se3_init(rot.astype(np.float32),
                                   np.asarray(trans, np.float32)))

    @staticmethod
    def from_matrix(mat):
        return SE3(mat)

    @staticmethod
    def exp(xi):
        """(..., 6) twist (omega, v) -> SE3 (rotation-coupled translation)."""
        xi = np.asarray(xi, np.float32)
        omega, v = xi[..., :3], xi[..., 3:]
        rot = se3_np.so3_exp(omega)
        theta = np.linalg.norm(omega, axis=-1, keepdims=True)
        theta = np.maximum(theta, 1e-12)
        axis = omega / theta
        k = se3_np.so3_hat(axis)
        th = theta[..., None]
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), k.shape)
        V = (eye + ((1 - np.cos(th)) / th) * k
             + ((th - np.sin(th)) / th) * (k @ k))
        trans = np.einsum("...ij,...j->...i", V, v)
        return SE3(se3_np.se3_init(rot.astype(np.float32),
                                   trans.astype(np.float32)))

    @staticmethod
    def pexp(xi):
        """Pseudo-exponential: rotation via exp, translation kept verbatim
        (reference cvhelpers/lie/torch/se3.py:114-135).  xi: (..., 6) as
        (omega, v) — NOTE the reference orders its twist (v, omega)."""
        xi = np.asarray(xi, np.float32)
        omega, v = xi[..., :3], xi[..., 3:]
        rot = se3_np.so3_exp(omega)
        return SE3(se3_np.se3_init(rot.astype(np.float32),
                                   v.astype(np.float32)))

    # -- analytic jacobians ---------------------------------------------------
    # Layout: rows = column-major flatten of the 3x4 matrix [c1 c2 c3 t]
    # (12 rows); columns = twist increment eps in OUR (omega, v) order —
    # cols 0:3 rotation, 3:6 translation.  The reference
    # (cvhelpers/lie/torch/se3.py:183-278) uses (v, omega) column order;
    # the blocks are identical up to that column swap.  A CPU test holds
    # them to the JAX package's, which are checked by finite differences.

    @staticmethod
    def jacob_expeD_de(poseD: "SE3"):
        """d(exp(eps) * D) / d eps at eps = 0.  Returns (..., 12, 6)."""
        m = poseD.data
        jac = np.zeros(m.shape[:-2] + (12, 6), np.float32)
        for col in range(4):
            jac[..., 3 * col: 3 * col + 3, 0:3] = \
                -se3_np.so3_hat(m[..., :3, col])
        jac[..., 9, 3] = 1.0
        jac[..., 10, 4] = 1.0
        jac[..., 11, 5] = 1.0
        return jac

    @staticmethod
    def jacob_Dexpe_de(poseD: "SE3"):
        """d(D * exp(eps)) / d eps at eps = 0.  Returns (..., 12, 6)."""
        m = poseD.data
        c1, c2, c3 = m[..., :3, 0], m[..., :3, 1], m[..., :3, 2]
        jac = np.zeros(m.shape[:-2] + (12, 6), np.float32)
        jac[..., 9:12, 3:6] = m[..., :3, :3]
        jac[..., 0:3, 1] = -c3
        jac[..., 0:3, 2] = c2
        jac[..., 3:6, 0] = c3
        jac[..., 3:6, 2] = -c1
        jac[..., 6:9, 0] = -c2
        jac[..., 6:9, 1] = c1
        return jac

    @staticmethod
    def jacob_dAexpeD_de(poseA: "SE3", poseD: "SE3",
                         full_matrix: bool = True):
        """d(A * exp(eps) * D) / d eps at eps = 0.

        full_matrix=True: (..., 12, 6).  Otherwise the five non-zero 3x3
        blocks stacked to (..., 15, 3) in the order (A, B, C, D, E) of the
        reference (se3.py:234-278)."""
        mA, mD = poseA.data, poseD.data
        rotA = mA[..., :3, :3]
        blocks = [rotA] + [
            -rotA @ se3_np.so3_hat(mD[..., :3, col]) for col in range(4)
        ]
        if not full_matrix:
            return np.concatenate(blocks, axis=-2)
        jac = np.zeros(mA.shape[:-2] + (12, 6), np.float32)
        jac[..., 9:12, 3:6] = blocks[0]
        for col in range(4):
            jac[..., 3 * col: 3 * col + 3, 0:3] = blocks[col + 1]
        return jac

    @staticmethod
    def sample_small(std: float = 0.1, rng=None):
        state = rng if isinstance(rng, np.random.RandomState) else \
            np.random.RandomState(np.random.randint(2 ** 31))
        from ..data.transforms import sample_small_pose

        return SE3(sample_small_pose(state, std))

    @staticmethod
    def sample_uniform(trans_mag: float = 1.0, rng=None):
        state = rng if isinstance(rng, np.random.RandomState) else \
            np.random.RandomState(np.random.randint(2 ** 31))
        rot = se3_np.sample_uniform_rotation(state)
        trans = state.uniform(-trans_mag, trans_mag, 3).astype(np.float32)
        return SE3(se3_np.se3_init(rot, trans))

    # -- ops ------------------------------------------------------------------
    def inv(self):
        return SE3(se3_np.se3_inv(self.data))

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(se3_np.se3_cat(self.data, other.data))
        return se3_np.se3_transform(self.data, np.asarray(other))

    def transform(self, xyz):
        return self * xyz

    def log(self):
        rot = SO3(self.data[..., :3, :3])
        omega = rot.log()
        theta = np.linalg.norm(omega, axis=-1, keepdims=True)
        theta = np.maximum(theta, 1e-12)
        axis = omega / theta
        k = se3_np.so3_hat(axis)
        th = theta[..., None]
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), k.shape)
        V = (eye + ((1 - np.cos(th)) / th) * k
             + ((th - np.sin(th)) / th) * (k @ k))
        v = np.linalg.solve(V, self.data[..., :3, 3][..., None])[..., 0]
        return np.concatenate([omega, v], axis=-1)

    @property
    def rot(self):
        return SO3(self.data[..., :3, :3])

    @property
    def trans(self):
        return self.data[..., :3, 3]

    def as_matrix(self):
        return self.data

    def as_matrix_4x4(self):
        bottom = np.zeros(self.data.shape[:-2] + (1, 4), np.float32)
        bottom[..., 0, 3] = 1.0
        return np.concatenate([self.data, bottom], axis=-2)

    def compare(self, other):
        other = other.data if isinstance(other, SE3) else np.asarray(other)
        return se3_np.se3_compare(self.data, other)

    @property
    def shape(self):
        return self.data.shape[:-2]

    def __repr__(self):
        return f"SE3({self.data.shape})"
