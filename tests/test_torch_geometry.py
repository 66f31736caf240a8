"""Parity of the port's geometry and losses with sba_tpu (float64, CPU).

The same numpy inputs go through the sba_tpu (JAX) function and its
sba_tpu_torch counterpart; outputs agree to atol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.geometry import camera_models as jcm
from sba_tpu.geometry import quaternions as jq
from sba_tpu.optim import losses as jl
from sba_tpu_torch.geometry import camera_models as tcm
from sba_tpu_torch.geometry import quaternions as tq
from sba_tpu_torch.optim import losses as tl

torch.set_num_threads(1)

ATOL = 1e-10


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _close(t_out, j_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol,
                               rtol=rtol)


def _quat_inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4))
    q2 = rng.normal(size=(16, 4))
    p = rng.normal(size=(16, 3))
    aa = rng.normal(scale=0.5, size=(16, 3))
    aa[:3] *= 1e-9   # the small-angle branches
    return q, q2, p, aa


_QUAT_CASES = {
    "normalize": lambda m, q, q2, p, aa: m.quat_normalize(q),
    "conjugate": lambda m, q, q2, p, aa: m.quat_conjugate(q),
    "inverse_rotation": lambda m, q, q2, p, aa: m.quat_inverse_rotation(q),
    "multiply": lambda m, q, q2, p, aa: m.quat_multiply(q, q2),
    "rotate": lambda m, q, q2, p, aa: m.quat_rotate(q, p),
    "to_rotmat": lambda m, q, q2, p, aa: m.quat_to_rotmat(q),
    "rotmat_to_quat": lambda m, q, q2, p, aa: m.rotmat_to_quat(
        m.quat_to_rotmat(q)),
    "angle_axis_to_quat": lambda m, q, q2, p, aa: m.angle_axis_to_quat(aa),
    "quat_to_angle_axis": lambda m, q, q2, p, aa: m.quat_to_angle_axis(q),
    "angle_axis_rotate": lambda m, q, q2, p, aa: m.angle_axis_rotate(aa, p),
    "retract": lambda m, q, q2, p, aa: m.quat_retract(q, aa),
    "pose_inverse": lambda m, q, q2, p, aa: m.pose_inverse(q, p)[1],
    "pose_product": lambda m, q, q2, p, aa: m.pose_product(q, p, q2, p)[1],
    "pose_transform": lambda m, q, q2, p, aa: m.pose_transform(q, p, p),
    "slerp": lambda m, q, q2, p, aa: m.quat_slerp(q, q2, 0.3),
}


@pytest.mark.parametrize("case", sorted(_QUAT_CASES))
def test_quaternion_function_matches_sba_tpu(case):
    inputs = _quat_inputs()
    fn = _QUAT_CASES[case]
    out_t = fn(tq, *[_t(a) for a in inputs])
    out_j = fn(jq, *[jnp.asarray(a) for a in inputs])
    _close(out_t, out_j)


def test_numpy_quaternion_helpers_match_sba_tpu():
    q, _, p, _ = _quat_inputs()
    np.testing.assert_allclose(tq.np_quat_rotate(q, p),
                               jq.np_quat_rotate(q, p), atol=ATOL)
    np.testing.assert_allclose(tq.np_quat_to_rotmat(q[0]),
                               jq.np_quat_to_rotmat(q[0]), atol=ATOL)


# Small nonzero distortion per model (as tests/test_ba_fused.py).
_DISTORT = {
    2: {3: 0.02}, 3: {3: 0.02, 4: -0.005},
    4: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    5: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3},
    6: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3, 9: 0.01,
        10: -2e-3, 11: 5e-4},
    7: {4: 0.08}, 8: {3: 0.02}, 9: {3: 0.02, 4: -0.005},
    10: {4: 0.02, 5: -0.005, 6: 1e-3, 7: -2e-3, 8: 1e-3, 9: -5e-4,
         10: 8e-4, 11: -6e-4},
}


@pytest.mark.parametrize("model_id", list(range(11)))
def test_camera_model_matches_sba_tpu(model_id):
    spec_t = tcm.model_by_id(model_id)
    spec_j = jcm.model_by_id(model_id)
    assert (spec_t.name, spec_t.num_params, spec_t.params_info) == \
        (spec_j.name, spec_j.num_params, spec_j.params_info)
    assert (spec_t.focal_idxs, spec_t.principal_idxs, spec_t.extra_idxs) == \
        (spec_j.focal_idxs, spec_j.principal_idxs, spec_j.extra_idxs)
    params = np.zeros(12)
    init = spec_j.init_params(500.0, 640, 480)
    params[:len(init)] = init
    for i, v in _DISTORT.get(model_id, {}).items():
        params[i] = v
    rng = np.random.default_rng(model_id)
    uv = rng.uniform(-0.4, 0.4, size=(32, 2))
    uv[0] = 0.0   # the r -> 0 guards
    xy_t = tcm.world_to_image(model_id, _t(params), _t(uv))
    xy_j = jcm.world_to_image(model_id, jnp.asarray(params), jnp.asarray(uv))
    _close(xy_t, xy_j)
    back_t = tcm.image_to_world(model_id, _t(params), xy_t)
    back_j = jcm.image_to_world(model_id, jnp.asarray(params), xy_j)
    _close(back_t, back_j)


def test_camera_model_switch_matches_sba_tpu():
    """The dispatch on a model id held as data (sba_tpu's `lax.switch`):
    each of the 11 models by a scalar id, and a batch of rows of mixed
    models (the switch under sba_tpu's vmap over ids), both directions,
    on zero-padded parameters."""
    import jax

    rng = np.random.default_rng(11)
    P = np.stack([tcm.pad_params(jcm.model_by_id(m).init_params(
        500.0, 640, 480)) for m in range(11)])
    for m, d in _DISTORT.items():
        for i, v in d.items():
            P[m, i] = v
    np.testing.assert_array_equal(P[3], jcm.pad_params(P[3][:6]))
    uv = rng.uniform(-0.4, 0.4, size=(11, 8, 2))
    for m in range(11):
        xy_t = tcm.world_to_image_switch(torch.tensor(m), _t(P[m]),
                                         _t(uv[m]))
        xy_j = jcm.world_to_image_switch(m, jnp.asarray(P[m]),
                                         jnp.asarray(uv[m]))
        _close(xy_t, xy_j)
        _close(tcm.image_to_world_switch(m, _t(P[m]), xy_t),
               jcm.image_to_world_switch(m, jnp.asarray(P[m]), xy_j))
    ids = np.array([0, 10, 4, 4, 7, 2, 9, 1])
    rows = uv[ids, np.arange(8)]
    xy_j = jax.vmap(jcm.world_to_image_switch)(jnp.asarray(ids),
                                               jnp.asarray(P[ids]),
                                               jnp.asarray(rows))
    xy_t = tcm.world_to_image_switch(torch.as_tensor(ids), _t(P[ids]),
                                     _t(rows))
    _close(xy_t, xy_j)
    _close(tcm.image_to_world_switch(torch.as_tensor(ids), _t(P[ids]),
                                     xy_t),
           jax.vmap(jcm.image_to_world_switch)(jnp.asarray(ids),
                                               jnp.asarray(P[ids]), xy_j))


@pytest.mark.parametrize("name", ["trivial", "huber", "soft_l1", "cauchy"])
def test_loss_matches_sba_tpu(name):
    s = np.concatenate([np.linspace(0.0, 10.0, 41), [1e-30, 0.5, 3.9]])
    for scale in (1.0, 2.0):
        _close(tl.loss_value(name, _t(s), scale),
               jl.loss_value(name, jnp.asarray(s), scale))
        _close(tl.loss_weight(name, _t(s), scale),
               jl.loss_weight(name, jnp.asarray(s), scale))
