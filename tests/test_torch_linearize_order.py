"""Kernel K8 (``csrc/ba_linearize.cu``: the FEJ Jacobians formed from the
window, f64 sums on the tensor cores, the pair blocks per (pair, tile) and
warp, the Schur sums per anchor frame, an 8-lane tree per output entry),
through its plain mirror ``dsopp_tpu_torch/testing/linearize_order.py``,
against the port's plain version and the JAX package.

On a 4-frame window (136 landmarks a frame: two pair tiles, a ragged chunk)
and on the dense operating point's 17 slots with 13 frames (dead slots, three
frames a reduction lane), moved off the linearization point, with and
without ``marg_pass``:

* with float64 operands the mirror, its FEJ formed from the window in the
  kernel's arithmetic (``linearize_order.fej_cache``), against
  ``_linearize_from_ev_plain`` on ``_fej_cache_plain`` in float64 and against
  JAX's ``_linearize_from_ev`` on JAX's ``_fej_cache`` (CPU, x64): every
  output within 1e-12 of its largest entry.  Both compute the same float64
  arithmetic; only the order of the long sums and of the FEJ's products
  differs, and the sums cancel down to no less than ~1e-4 of the largest
  entry here, so 1e-12 leaves room for their rounding (~1e-16 relative a
  term) and catches any misplaced or missing term;
* with float32 operands (the card's), the order of summation alone
  (``linearize_order.linearize_from_fej`` on the float32 rounding of JAX's
  cache), against the plain version in float64 on the same float32 inputs:
  every output within 5e-7 relative (Frobenius).  The mirror rounds each
  Jacobian entry, ``w J``, the 8-point sums and its outputs in float32 (~6e-8
  each), as the kernel does, and its long sums add nothing measurable: it
  lands within 8e-8 here, the plain float32 version (float32 sums) within
  2.2e-7.  The card's gate (1e-4 against the plain float32 version) is wider
  still;
* the mirror's float32 FEJ (the kernel's arithmetic) against
  ``_fej_cache_plain`` in float32 on the same window, with and without the
  marginalization pass's flagged frame: each row of ``d uv / d eps`` within
  ``FEJ_ULPS`` ulps of its largest entry (2 seen), the corrected reference
  within ``FEJ_ULPS`` ulps of itself, the brightness scales within 2 ulps
  (``exp`` is the library's on each side), the validity equal; ``d uv / d
  idepth`` = J t, whose relative translation t both versions round in f32
  with cancellation (each lands up to 600 ulps of the row from the float64
  value here), within ``IDEPTH_ULPS`` of the row, and both FEJ within 2e-7
  relative (Frobenius) of the float64 one.  The kernel's relative pose differs
  from the plain one by up to ``parity.KERNEL_POSE_ULPS``, and the two
  reproject in other orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing import linearize_order, parity

from tests._torch_port import window_fields

# name -> (slots, frames, landmarks per frame)
SIZES = {"k4": (4, [0, 2, 4, 6], 136), "k17": (17, list(range(13)), 40)}
# the f32 FEJ of the kernel's arithmetic against the plain version's, in ulps
# of a row's largest entry: d uv / d eps and the corrected reference (2 seen),
# d uv / d idepth (512 seen: the rounding of the relative translation)
FEJ_ULPS = 8
IDEPTH_ULPS = 1024


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module", params=list(SIZES))
def problem(request):
    slots, frames, n_lm = SIZES[request.param]
    seq = render_sequence(num_frames=max(frames) + 1, height=120, width=160)
    window = build_test_window(seq, frames, num_landmarks=n_lm, slots=slots,
                               pose_noise=3e-3, idepth_noise=0.05, seed=11)
    rng = np.random.default_rng(5)
    eps = rng.normal(size=(slots, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps *= np.asarray(window.frame_valid & ~window.frame_fixed)[:, None]
    marg = np.zeros(slots, bool)
    marg[1] = True
    window = dataclasses.replace(
        window, eps=jnp.asarray(eps), frame_marg=jnp.asarray(marg),
        affine0=jnp.asarray(rng.normal(size=(slots, 2)) * [0.02, 1.0]),
        lm_valid=window.lm_valid & jnp.asarray(rng.random((slots, n_lm)) < 0.9))
    idepth = window.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(slots, n_lm)))
    opts = jpba.PBAOptions()
    fej = jpba._fej_cache(window, seq.camera)
    ev = jpba._evaluate(window, seq.camera, window.eps, idepth, jpba.active_lm_mask(window), opts)
    jax_sys = {m: jpba._linearize_from_ev(window, fej, ev, window.eps, opts, marg_pass=m)
               for m in (False, True)}
    cam = seq.camera
    return dict(window=window_fields(window), fej=_fields(fej), ev=_fields(ev),
                cam=convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size),
                jax_sys={m: _fields(s) for m, s in jax_sys.items()})


def _port(problem, dtype):
    """(window, camera, evaluation, eps) of the port in ``dtype``."""
    tw = convert.window(problem["window"], dtype=dtype)
    return tw, problem["cam"], convert.evaluation(problem["ev"], dtype=dtype), tw.eps


def _within(got, want, tol, name):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert scale > 0, name
    assert err <= tol * scale, (name, err / scale)


@pytest.mark.parametrize("marg_pass", [False, True])
def test_mirror_matches_plain_and_jax_in_f64(problem, marg_pass):
    tw, cam, ev, eps = _port(problem, torch.float64)
    opts = tpba.PBAOptions()
    mirror = linearize_order.linearize(tw, cam, ev, eps, opts, marg_pass)
    plain = tpba._linearize_from_ev_plain(tw, tpba._fej_cache_plain(tw, cam), ev, eps, opts,
                                          marg_pass)
    jax = convert.linear_system(problem["jax_sys"][marg_pass])
    assert int((plain.inv_hdd > 0).sum()) > 100
    for name in tpba.LinearSystem._fields:
        got = getattr(mirror, name)
        assert got.shape == getattr(plain, name).shape and got.dtype == torch.float64, name
        _within(got, getattr(plain, name), 1e-12, name)
        _within(got, getattr(jax, name), 1e-12, name)


@pytest.mark.parametrize("marg_pass", [False, True])
def test_mirror_in_f32_matches_plain_f64(problem, marg_pass):
    tw, _, ev, eps = _port(problem, torch.float32)
    fej = convert.fej_cache(problem["fej"], dtype=torch.float32)
    opts = tpba.PBAOptions()
    mirror = linearize_order.linearize_from_fej(tw, fej, ev, eps, opts, marg_pass)
    ref = tpba._linearize_from_ev_plain(parity.to_f64(tw), parity.to_f64(fej),
                                        parity.to_f64(ev), eps.double(), opts, marg_pass)
    for name in tpba.LinearSystem._fields:
        got, want = getattr(mirror, name), getattr(ref, name)
        assert got.dtype == torch.float32, name
        rel = float((got.double() - want).norm() / want.norm())
        assert rel <= 5e-7, (name, rel)


def _row_ulps(got, want, rows):
    """Largest |got - want| in f32 ulps of the largest |entry| of each row
    (the last ``rows`` dimensions form a row)."""
    dims = tuple(range(-rows, 0))
    scale = torch.maximum(got.abs(), want.abs()).amax(dim=dims, keepdim=True)
    ulp = torch.as_tensor(np.spacing(scale.numpy().astype(np.float32)))
    return float(((got.double() - want.double()).abs() / ulp).max())


@pytest.mark.parametrize("marg_pass", [False, True])
def test_mirror_fej_in_f32_within_ulps_of_plain(problem, marg_pass):
    """The kernel's FEJ arithmetic in f32 against ``_fej_cache_plain`` in f32
    on the same window (the FEJ do not depend on ``marg_pass``: the frame
    flagged for the marginalization pass only moves which rows K8 sums)."""
    tw, cam, _, _ = _port(problem, torch.float32)
    if marg_pass:
        tw = tw.replace(frame_marg=~tw.frame_marg & tw.frame_valid)
    mirror = linearize_order.fej_cache(tw, cam)
    plain = tpba._fej_cache_plain(tw, cam)
    assert mirror.d_uv_ref.dtype == torch.float32
    assert torch.equal(mirror.geom_valid, plain.geom_valid)
    assert int(plain.geom_valid.sum()) > 100
    seen = {name: _row_ulps(getattr(mirror, name), getattr(plain, name), 1)
            for name in ("d_uv_ref", "d_uv_tgt", "d_uv_idepth")}
    seen["corrected_ref"] = _row_ulps(mirror.corrected_ref[..., None],
                                      plain.corrected_ref[..., None], 1)
    seen["scale0"] = _row_ulps(mirror.scale0[..., None], plain.scale0[..., None], 1)
    assert seen["scale0"] <= 2, seen
    assert seen.pop("d_uv_idepth") <= IDEPTH_ULPS, seen
    assert max(seen.values()) <= FEJ_ULPS, seen
    tw64 = parity.to_f64(tw)
    ref = tpba._fej_cache_plain(tw64, cam)
    for fej in (mirror, plain):
        for name in ("d_uv_ref", "d_uv_tgt", "d_uv_idepth"):
            got, want = getattr(fej, name).double(), getattr(ref, name)
            assert float((got - want).norm() / want.norm()) <= 2e-7, name
