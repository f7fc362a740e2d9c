"""K5's entry with the frontend's reliability gate and keyframe decision
(``tracker/depth_map.py::frame_statistics``), f64 on the CPU:

* the plain version against the JAX package's ``_frontend_core`` gate and
  decision (its regular tick replaced by one that returns the case's rmse,
  valid count and JAX's flows of the case's flow set): the flows 1e-12
  relative, the state's next ``rmse_last0`` and ``kf_rmse`` and the keyframe
  flag exact, the gate as its formula gives it, on a forced keyframe, an
  unset strategy memory (``kf_rmse < 0``), an unreliable frame, a frame with
  no valid point, and both sides of ``KEYFRAME_THRESHOLD`` and of
  ``MAX_EXCESS_ENERGY``;
* ``testing/frontend_models.py::flow_block_sums``, the kernel's order of the
  flow sums (a thread per point, each block's partial in a fixed order, the
  partials added in block index order by the block that finishes last): the
  same bits whatever the order in which the blocks finish, at every block
  count; the f32 flows equal to the one-block order of the kernel before;
* the host's bookkeeping of a regular frame reads only the frame's host
  copy of the statistics; the dispatcher runs the plain version on CPU
  tensors and the kernel wrappers refuse them.
"""

import types
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.solvers.pose_alignment import LevelPoints as JLevelPoints
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker import depth_map as jdm
from dsopp_tpu.tracker import device_loop as jdl
from dsopp_tpu_torch import convert, kernels
from dsopp_tpu_torch.testing import frontend_models as fm
from dsopp_tpu_torch.tracker import depth_map as tdm
from dsopp_tpu_torch.tracker import device_loop as tdl

from tests._torch_port import assert_close, to_torch

N_POINTS = 700
# what JAX's _frontend_core reads of its regular tick's result
_Tick = namedtuple("_Tick", "rmse num_valid flow flow_no_rot pose_q pose_t affine immature")
# case -> (rmse, rmse_last0, kf_rmse, num_valid, force_kf, shift): ``shift`` is
# the strategy's flow term factor · (4.5 flow + 9 flow_no_rot) over
# KEYFRAME_THRESHOLD, set through the factor
CASES = {
    "quiet": (1.0, 1.0, 0.5, 50, False, 0.5),
    "flow_above": (1.0, 1.0, 0.5, 50, False, 2.0),
    "energy_above": (1.0, 1.0, 0.2, 50, False, 0.5),
    "energy_below": (1.0, 1.0, 0.3, 50, False, 0.5),
    "kf_rmse_unset": (1.0, 1.0, -1.0, 50, False, 0.5),
    "kf_rmse_unset_flow": (1.0, 1.0, -1.0, 50, False, 2.0),
    "unreliable": (3.0, 1.0, 0.5, 50, False, 2.0),
    "no_valid_point": (1.0, 1.0, 0.2, 0, False, 2.0),
    "forced": (1.0, 1.0, 0.5, 50, True, 2.0),
    "forced_quiet": (1.0, 1.0, 0.5, 50, True, 0.5),
}


@pytest.fixture(scope="module")
def flow_case():
    """A flow set on a rendered frame's camera and a pose, both packages'."""
    rng = np.random.default_rng(14)
    seq = render_sequence(num_frames=2, height=120, width=160)
    cam = seq.camera
    tcam = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    uv = rng.uniform([-2.0, -2.0], [162.0, 122.0], size=(N_POINTS, 2))
    idepth = rng.uniform(-0.1, 1.5, size=N_POINTS) * (rng.random(N_POINTS) < 0.9)
    valid = rng.random(N_POINTS) < 0.85
    pose = JSE3.exp(jnp.asarray(rng.normal(size=6) * np.array([0.05] * 3 + [0.02] * 3)))
    pts = (uv, idepth, rng.random(N_POINTS), valid)
    jflows = jdm.mean_square_flows(JLevelPoints(*map(jnp.asarray, pts)), cam, pose)
    return dict(cam=cam, tcam=tcam, jpts=JLevelPoints(*map(jnp.asarray, pts)),
                tpts=convert.level_points(*pts), pose=pose, jflows=jflows,
                mat=rng.normal(size=(4, 4)))


def _jax_decision(monkeypatch, fc, rmse, rmse_last0, kf_rmse, num_valid, force, factor):
    """JAX's ``_frontend_core`` on the case: its regular tick returns the
    case's values → (next rmse_last0, next kf_rmse, need_kf)."""
    flow, flow_no_rot = fc["jflows"]

    def tick(*args, **kwargs):
        return _Tick(
            rmse=jnp.asarray(rmse), num_valid=jnp.asarray(num_valid, jnp.int32), flow=flow,
            flow_no_rot=flow_no_rot, pose_q=jnp.asarray([1.0, 0.0, 0.0, 0.0]),
            pose_t=jnp.zeros(3), affine=jnp.zeros(2), immature=None)

    monkeypatch.setattr(jdl, "fused_regular_tick", tick)
    ident = JSE3(jnp.asarray([[1.0, 0.0, 0.0, 0.0]] * 2), jnp.zeros((2, 3)))
    window = types.SimpleNamespace(poses=lambda: ident, frame_valid=jnp.ones(2, bool),
                                   affine=lambda: jnp.zeros((2, 2)), exposure=jnp.ones(2))
    state = jdl.DeviceTrackerState(
        window=window, immature=None, depth_idepth=None, depth_weight=None,
        level_points=None, flow_points=None, last_q=jnp.asarray([1.0, 0.0, 0.0, 0.0]),
        last_t=jnp.zeros(3), prev_q=jnp.asarray([1.0, 0.0, 0.0, 0.0]), prev_t=jnp.zeros(3),
        last_affine=jnp.zeros(2), rmse_last0=jnp.asarray(rmse_last0),
        kf_rmse=jnp.asarray(kf_rmse), min_distance=jnp.asarray(2.0))
    cfg = types.SimpleNamespace(keyframe_factor=factor, align_opts=None,
                                with_perturbations=False, num_levels=1, huber_sigma=20.0)
    base, need, _ = jdl._frontend_core(state, jnp.zeros((1, 1)), jnp.asarray(force), None,
                                       cfg)
    return float(base.rmse_last0), float(base.kf_rmse), bool(need)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_statistics_match_the_jax_gate_and_decision(monkeypatch, flow_case, case):
    rmse, rmse_last0, kf_rmse, num_valid, force, shift = CASES[case]
    flow, flow_no_rot = (float(x) for x in flow_case["jflows"])
    term = tdm.MAX_SHIFT_WEIGHT * flow + tdm.MAX_SHIFT_NO_ROT_WEIGHT * flow_no_rot
    factor = shift * tdm.KEYFRAME_THRESHOLD / term
    want_r0, want_kf, want_need = _jax_decision(monkeypatch, flow_case, rmse, rmse_last0,
                                                kf_rmse, num_valid, force, factor)
    pose = flow_case["pose"]
    mat = to_torch(flow_case["mat"])
    f64 = dict(dtype=torch.float64)
    stats = tdm.frame_statistics(
        flow_case["tpts"], flow_case["tcam"], convert.se3(pose.q, pose.t), mat,
        torch.tensor(rmse, **f64), torch.tensor(num_valid, dtype=torch.int32),
        torch.tensor(rmse_last0, **f64), torch.tensor(kf_rmse, **f64), factor, force)
    assert stats.shape == (tdm.STATS,) and stats.dtype == torch.float64
    assert_close(stats[tdm.STAT_FLOW], flow, rtol=1e-12)
    assert_close(stats[tdm.STAT_FLOW_NO_ROT], flow_no_rot, rtol=1e-12)
    reliable = rmse < tdm.ENERGY_RATIO_THRESHOLD * rmse_last0 and num_valid > 0
    assert float(stats[tdm.STAT_RELIABLE]) == float(reliable)
    assert float(stats[tdm.STAT_RMSE_LAST0]) == want_r0
    assert float(stats[tdm.STAT_KF_RMSE]) == want_kf
    assert (force or bool(stats[tdm.STAT_NEED])) == want_need
    assert float(stats[tdm.STAT_RMSE]) == rmse
    assert torch.equal(stats[tdm.STAT_MATRIX:].reshape(4, 4), mat)
    # each case decides as its name says
    expect = {"flow_above", "energy_above", "kf_rmse_unset_flow", "forced", "forced_quiet"}
    assert want_need == (case in expect)


@pytest.mark.parametrize("n", [8192, 700, 255])
def test_flow_sum_order_is_fixed_whatever_the_blocks_finish(n):
    """The kernel's grid at ``n`` points and at other block counts: any order
    in which the blocks finish gives the same bits; the f64 sum meets numpy's,
    and the f32 flow equals the one the kernel before (one block of 1024
    threads) gave on the same terms."""
    rng = np.random.default_rng(n)
    terms = (rng.random(n) * rng.choice([1e-6, 1e-3, 1.0], size=n)).astype(np.float32)
    ok = rng.random(n) < 0.7
    want = np.sum(terms[ok].astype(np.float64))
    before = fm.flow_from_sums(*fm.flow_block_sums(terms, ok, 1, threads=1024))
    assert fm.flow_blocks(8192) == 32 and fm.flow_blocks(255) == 1
    for blocks in sorted({1, 2, 7, fm.flow_blocks(n), fm.FLOW_MAX_BLOCKS}):
        total, count = fm.flow_block_sums(terms, ok, blocks)
        assert count == int(ok.sum())
        assert abs(total - want) <= 1e-12 * want
        for _ in range(4):
            again = fm.flow_block_sums(terms, ok, blocks, finish=rng.permutation(blocks))
            assert again == (total, count)
        assert fm.flow_from_sums(total, count) == before, blocks


class _Unread:
    """A device value that must not be read."""

    def __float__(self):
        raise AssertionError("a regular frame's bookkeeping read a device value")

    def cpu(self):
        raise AssertionError("a regular frame's bookkeeping copied a device value")


def test_regular_frame_bookkeeping_reads_the_host_copy():
    attached = []
    pipe = object.__new__(tdl.PipelinedTracker)
    pipe.tracker = types.SimpleNamespace(track=types.SimpleNamespace(attach_frame=attached.append))
    pipe._sem_pending, pipe.cur_kf = {}, 3
    host = np.arange(tdm.STATS, dtype=np.float32) + 0.5
    diag = types.SimpleNamespace(is_keyframe=False, flow=_Unread(), flow_no_rot=_Unread(),
                                 rmse=_Unread(), t_kf_frame_mat=_Unread(), host_stats=host)
    pipe._bookkeep(7, 0.25, diag)
    (frame,) = attached
    assert frame.flow == host[tdm.STAT_FLOW]
    assert frame.flow_without_rotation == host[tdm.STAT_FLOW_NO_ROT]
    assert frame.rmse == host[tdm.STAT_RMSE]
    assert frame.t_keyframe_frame.dtype == np.float64
    assert np.array_equal(frame.t_keyframe_frame, host[tdm.STAT_MATRIX:].reshape(4, 4))


def test_statistics_dispatcher_runs_plain_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(tdm, "frame_statistics_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tdm, "frame_statistics_cuda", lambda *a, **k: calls.append("cuda"))
    pts = tdm.LevelPoints(torch.zeros(8, 2), torch.ones(8), torch.ones(8),
                          torch.ones(8, dtype=torch.bool))
    tdm.frame_statistics(pts, None, None, None, None, None, None, None, 1.0, False)
    assert calls == ["plain"]


def test_statistics_wrapper_refuses_cpu_tensors(flow_case):
    pts = tdm.LevelPoints(*(x.float() if x.is_floating_point() else x
                            for x in flow_case["tpts"]))
    pose = flow_case["pose"]
    t = convert.se3(pose.q, pose.t)
    one = torch.tensor(1.0)
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        tdm.frame_statistics_cuda(pts, flow_case["tcam"], type(t)(t.q.float(), t.t.float()),
                                  torch.eye(4), one, torch.tensor(5, dtype=torch.int32), one,
                                  one, 1.0, False)
    assert kernels.counts() == before
