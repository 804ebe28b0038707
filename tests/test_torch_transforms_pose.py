"""The port's pose functions (color_neus_torch/ops/transforms.py) against the
JAX package's (color_neus_tpu/ops/transforms.py:64,161-257) on the CPU:
rotmat_to_aa, aa_to_quat, quat_to_aa, quat_to_rotmat, rotmat_to_rot6d,
slerp, rotmat_interpolate and se3_interpolate, on seeded numpy inputs and
on the small-angle, identity and slerp endpoint cases of
tests/test_ops.py:242-290. Tolerance: atol 1e-6 between the two packages
(both f32; the functions are the same formulas), and test_ops.py's own
tolerances for the round trips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.ops import transforms as JT

from color_neus_torch.ops import transforms as T

ATOL = 1e-6


def _j(f, *xs):
    return np.asarray(f(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in xs]))


def _t(f, *xs):
    out = f(*[torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x for x in xs])
    return out.numpy() if torch.is_tensor(out) else out


def _rotations(n, seed, scale=1.2):
    aa = (np.random.RandomState(seed).randn(n, 3) * scale).astype(np.float32)
    return np.asarray(JT.aa_to_rotmat(jnp.asarray(aa)))


# seeded inputs and the special cases: tiny angles (the series branches),
# zero, the identity matrix, rotations past pi / 2 about each axis (each
# Shepperd pivot wins once)
AA_CASES = {
    "seeded": (np.random.RandomState(11).randn(12, 3) * 1.2).astype(np.float32),
    "small": (np.random.RandomState(12).randn(6, 3) * 1e-8).astype(np.float32),
    "zero": np.zeros((2, 3), np.float32),
    "axes": np.asarray([[3.0, 0, 0], [0, 3.0, 0], [0, 0, 3.0], [0.5, -0.2, 0.1]], np.float32),
}


@pytest.mark.parametrize("case", sorted(AA_CASES))
def test_aa_quat_conversions_match_jax(case):
    aa = AA_CASES[case]
    q = _j(JT.aa_to_quat, aa)
    np.testing.assert_allclose(_t(T.aa_to_quat, aa), q, atol=ATOL)
    np.testing.assert_allclose(_t(T.quat_to_aa, q), _j(JT.quat_to_aa, q), atol=ATOL)
    np.testing.assert_allclose(_t(T.quat_to_rotmat, q), _j(JT.quat_to_rotmat, q), atol=ATOL)
    R = _j(JT.aa_to_rotmat, aa)
    np.testing.assert_allclose(_t(T.rotmat_to_aa, R), _j(JT.rotmat_to_aa, R), atol=ATOL)
    np.testing.assert_allclose(_t(T.rotmat_to_rot6d, R), _j(JT.rotmat_to_rot6d, R), atol=ATOL)


def test_identity_and_round_trips():
    """tests/test_ops.py's round trips on the port: the identity's axis-angle
    is 0, the quaternion has unit norm and returns the axis-angle, 6d
    returns the matrix."""
    eye = np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(_t(T.rotmat_to_aa, eye), 0.0, atol=ATOL)
    np.testing.assert_allclose(_t(T.rotmat_to_aa, eye), _j(JT.rotmat_to_aa, eye), atol=ATOL)
    aa = (np.random.RandomState(12).randn(10, 3)).astype(np.float32)
    q = _t(T.aa_to_quat, aa)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(_t(T.quat_to_aa, q), aa, atol=1e-4)
    np.testing.assert_allclose(_t(T.quat_to_rotmat, q), _t(T.aa_to_rotmat, aa), atol=1e-5)
    R = _t(T.aa_to_rotmat, (np.random.RandomState(13).randn(6, 3)).astype(np.float32))
    np.testing.assert_allclose(_t(T.rot6d_to_rotmat, _t(T.rotmat_to_rot6d, R)), R, atol=1e-5)
    small = (np.random.RandomState(11).randn(8, 3) * 0.8).astype(np.float32)
    np.testing.assert_allclose(_t(T.rotmat_to_aa, _t(T.aa_to_rotmat, small)), small, atol=1e-4)


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 1.0])
def test_slerp_matches_jax_and_its_endpoints(ratio):
    """slerp of the identity and a quarter turn about z (test_ops.py's
    case), of two seeded quaternions on opposite hemispheres (the sign
    flip) and of two nearly equal ones (the linear branch): equal to JAX's;
    the endpoints are the inputs."""
    rng = np.random.RandomState(14)
    q0 = np.asarray([1.0, 0, 0, 0], np.float32)
    q1 = _j(JT.aa_to_quat, np.asarray([0.0, 0.0, np.pi / 2], np.float32))
    a, b = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    b = -np.abs(b) * np.sign(a)   # dot < 0: the shorter arc flips q0
    c = a + 1e-4 * rng.randn(4).astype(np.float32)
    for x, y in ((q0, q1), (a, b), (a, c)):
        np.testing.assert_allclose(_t(T.slerp, x, y, ratio), _j(JT.slerp, x, y, ratio),
                                   atol=ATOL)
    if ratio in (0.0, 1.0):
        np.testing.assert_allclose(_t(T.slerp, q0, q1, ratio), q0 if ratio == 0 else q1,
                                   atol=1e-5)
    if ratio == 0.5:
        want = _j(JT.aa_to_quat, np.asarray([0.0, 0.0, np.pi / 4], np.float32))
        np.testing.assert_allclose(_t(T.slerp, q0, q1, ratio), want, atol=1e-5)


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5, 1.0])
def test_pose_interpolation_matches_jax(ratio):
    R0, R1 = _rotations(2, 15)
    np.testing.assert_allclose(T.rotmat_interpolate(R0, R1, ratio),
                               JT.rotmat_interpolate(R0, R1, ratio), atol=ATOL)
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, :3] = np.asarray(JT.aa_to_rotmat(jnp.asarray([0.0, 0.0, np.pi / 2])))
    T1[:3, 3] = [2, 0, 0]
    got = T.se3_interpolate(T0, T1, ratio)
    np.testing.assert_allclose(got, JT.se3_interpolate(T0, T1, ratio), atol=ATOL)
    if ratio == 0.5:   # test_ops.py's expectation
        np.testing.assert_allclose(got[:3, 3], [1, 0, 0], atol=1e-6)
        expect = np.asarray(JT.aa_to_rotmat(jnp.asarray([0.0, 0.0, np.pi / 4])))
        np.testing.assert_allclose(got[:3, :3], expect, atol=1e-5)
