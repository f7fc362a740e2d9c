"""The hand-written CUDA kernels against their plain PyTorch versions, f32
on the card (marked ``gpu``; skipped without a CUDA device).

Tolerances (intensities 0..255): K1 equal to the bit, one launch a
pyramid, at 5 and 4 levels and odd sizes; K2 num_valid exact, H and b
1e-4 relative (Frobenius), energy 1e-5 relative; K4 (the whole update, on
two banks of a rendered frame and on the small and the dense window) best
sample equal on ≥ 99.9 % and status on ≥ 99.5 % of active landmarks,
refined GN energy 1e-4 relative where the winners agree, its outputs equal
to the bit to the plain geometry and update on its own relative poses and
sweep, its poses within ``parity.KERNEL_POSE_ULPS`` of torch's composition,
two runs equal to the bit, its wrapper allocations and one kernel with no
host read, and its outputs on the inputs of ``testing/bits.py``'s ``k4`` case equal
to the chain it replaced, digest by digest; K3 num_valid within 0.5 %, energy and rmse 1e-3 relative,
rotation 1e-4 rad and translation 1e-4 m of the plain version (the result is
held, not the iteration trace: one accept/reject can flip by rounding; a
hypothesis is left out of the pose gate only where the two decision traces
show that flip: the same λ, and relative changes of the energy that differ by
at most ``parity.ALIGN_TIE`` and fall on either side of the decision's limit), at 1,
5 and 105 hypotheses with and without a trace, two runs and the traced run
equal to the bit; K7 ok and
status_candidate equal on ≥ 99.9 % of live groups, the rest 1e-4 relative
on the agreeing ones; K8 (its FEJ Jacobians, once kernel K6's cache, formed
inside from the window) every output 1e-4 relative (Frobenius) of the plain
version on ``_fej_cache_plain``, also with ``marg_pass=True``, on a small
window and on the dense operating point's (17 slots × 340 landmarks), two
runs equal to the bit, one launch of its own a call and ``_fej_cache``
refusing the card's window; K5 both flows 1e-5
relative, alone and with the gate and the keyframe decision (those equal
to the bit to the torch decision on the kernel's flows, one launch with no
host read), and with K14's pairing equal, digest by digest, to the chains
they replaced on the inputs of ``testing/bits.py``'s ``frame`` case, and,
launched on two side streams in turn, equal to the default stream's; K9 pose and idepth step 1e-4 of the step's norm against the plain
version in f64 arithmetic on the same f32 inputs (the plain f32 solve's own
distance from it is reported by ``chip_smoke.py``), also at K = 10, 17 and 21
on a system whose rows need a swap at nearly every column, with a dead slot
and in the loop-state mode, two runs equal to the bit, and without ledger and
Schur term (an exact assembly) equal to the bit to the column-by-column LU in
f64; K10 the same accept / done / relinearize sequence as the host-driven
loop, final energy 1e-4 relative, poses 1e-4 rad and 1e-4 m, statuses equal on
≥ 99.9 % of live groups, no host synchronisation inside; the whole solve in
one C call (``ba_solve_loop``) under those gates on the small and the dense
window with an empty and a filled ledger, its launches added to K7-K11's
counts, two calls equal to the bit, its wrapper allocations and one C call,
and its outputs on the inputs of ``testing/bits.py``'s ``solve`` case equal to the tree's
whose loop was launched from Python, digest by digest; the landmark-sharded
solve's Python-issued sequence on one ``lm`` rank equal to the one C call to
the bit, launches and LM log included; K10 given the trial's landmark sums
(the f64 pair a sharded solve all-reduces) deciding and committing as K10
summing them itself; K11 on two shards' gathered evaluation equal to the bit
to K11 on the whole; K11 threshold 1e-6
relative, statuses, counts and flags equal outside the 1e-6 band around the
threshold; K12 positions, validity and slot order equal and grad2 equal to the
bit, with and without a mask, also at VGA where every score ties; K13 n_active equal, masks equal on ≥ 99.9 % of
candidates and every difference a rounding tie (least distance within 2e-4 px
of min_distance, or the reprojection within 1e-3 px of the image border); K14
selected equal, keep equal on ≥ 99.5 % of the selected, idepth 1e-4 relative
where the accept sequences are equal, the pairing equal entry by entry on the
same inputs, with the refinement's glue inside (its bounds equal too) and
without a refinement, in one launch with no clone and no memset, the
caller's window and banks untouched; K13 and K14's refinement also on the
dense window, two runs equal to the bit, and their wrappers run no torch
operator but allocations; K16 (landmarks within 1e-3 px of a pixel boundary left out of
both) weights and selected pixels equal, idepth 1e-6 relative, on a small and
on the dense window, two runs equal to the bit, at most 16 launches and no
memset a call, its call (checks, the stream's scratch, two allocations and
one C call) issuing only ``depth_maps.cu``'s kernels with no host read and
no torch operator but allocations and views, its composed poses within
``parity.KERNEL_POSE_ULPS`` of torch's; K15 (the ledger fold from K8's marginalization-pass system
raw, on an empty and a filled ledger, with no frame, one free frame, two
frames, the fixed frame, a dead frame and five frames flagged)
H_m, b_m and E_m within 1e-9 of their largest entry, of the plain version's
or, where an eigenvalue lies within 1e-6 (relative) of the pseudo-inverse's
cutoff, of the plain version's with the cutoff at either edge of that band;
the Jacobi solver converged; two runs equal to the bit, the window it leaves
equal; its wrapper running no torch operator but allocations, with no host
read; K11 and K15 launched on two side streams in turn equal to the default
stream's; K15p (the policy) flags, outliers and the permutation equal, or, where
the two best eq (20) scores tie within their bounds
(``parity.eq20_score_bounds``: the kernel composes the positions itself),
frame flags that differ on those two slots only and the plain triage of the
kernel's frame flags, two runs equal to the bit, its wrapper running no torch
operator but allocations and one kernel a call; the row
gather equal to ``table[idx]`` to the bit in f32 and bf16, also at a tile's
ragged end (m of 1, 31, an odd count, 204801), at rows of 8 to 256 bytes and
from an unaligned index view, an index outside the table a zero row; K18
(the photometric correction) equal to the bit on u8 and f32 frames, with and
without a vignette, at VGA and at 479x637, and as the camera's one-call
intake from a pinned buffer (without and with SimpleRadial tables, cropped
to a multiple of 16) to the plain chain on the CPU, and on a crop's view;
``Camera.next_frame`` and the class-id image's upload with no host sync,
one K18 launch a frame; the pinned ring under a long kernel (the fourth
frame waits for its buffer, every frame right). K12-K16 and K18 run with
host synchronisation an error.

The feature-based bootstrap (``fbs/``): the corners on the card equal to the
plain version's, ``pyr_lk`` within 1e-3 px of it with its status equal and no
host read, the SO3×S2 refinement within 1e-9 of the CPU's with no host sync in
its loop; the app's tracked phase syncing no more than the standart path's.

At C = 2 and 3 frame-embedder channels (a tracker with the filter-bank
embedder, and its window's first two channels): K1's channel map 1e-3 abs;
K7, K8 (both passes, two runs equal), K10 and K11 (C = 3), K2 and K3 with
the tolerances above; K14's pairing, which samples the moved points'
C-channel patches, equal entry by entry.  At C = 1 the outputs of K1, K3,
K7, K8, K10 and K11 on the inputs of ``testing/bits.py``'s ``c1`` case equal the tree's
before the channel axis, digest by digest.

The track's outputs (no kernel of their own): ``pose_covariances`` with K7
and K8 once each, within ``parity.POSE_COV_F32_TOL`` of the plain version in
f32; ``solve_window`` without its readback and ``marginalize`` with its flags
given reading nothing on the host, equal to the bit to the one-call solve
and the fold; a run saved, loaded and resumed within 1e-6 m of the straight
run, every kernel of the path launched after the resume.

The batched tick (``tracker/batched_loop.py``), four sequences bootstrapped on
offset copies of a 240×320 corridor: K1, K3 (level 1's 5 hypotheses a
sequence, level 0's one, the re-track's 105 for every second sequence), K4
and K5 over B = 1, 2 and 4 of them in one launch, each sequence equal to the
bit to its own launch, with no host read; one batched tick equal to the four ``device_tick``
calls (the first stage that parts named otherwise), and the regular tick's
launches at B = 4 those at B = 1 when the escalation outcome is the same.
The keyframe backend's solver half over a sequence axis: the BA solve, the
policy K15p, the marginalization pass and the fold K15 of S = 1, 2 and 4 of
four starts of the dense window (``testing/batched.py::solver_starts``) in
one call a step, every step equal to the bit to S solo calls (the LM logs
too; also at C = 3 on the embedder's window), with no host read, and the
half's hand-written launches (the
wrappers' counts and the launch calls outside torch operators) one solo
half's; ``batched_solve_and_marginalize`` equal to the bit to the per-window
loop; a batched tick with every sequence forced to keyframe equal to the
four forced ``device_tick`` calls to the bit, ledger included.
The keyframe backend's front half and depth maps over a sequence axis: the
push, K12 and the banks, K13, K14 (both entries) and K16 of S = 1, 2 and 4 of
the four sequences at a forced keyframe in one call each, equal to the bit to
S solo calls (window, banks, slots, counts, depth maps, point sets; also at C =
3 with one K1 launch for the channel maps), with no host read, the same
hand-written launches as one solo call; each of those kernels at S = 4 equal
to its solo wrapper's launches; a batched tick where three of four sequences
keyframe equal to the solo ticks, the stacked maps keeping their storage.

Run on a machine with a card:
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features import extractor, pyramid
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.solvers import pose_alignment as pa
from dsopp_tpu_torch.testing import align_trace, gather_probe, parity, render_sequence
from dsopp_tpu_torch.testing.profiling import launch_records, profiled
from dsopp_tpu_torch.tracker import activation as act
from dsopp_tpu_torch.tracker import depth_estimation as de
from dsopp_tpu_torch.tracker import depth_map as dm
from dsopp_tpu_torch.tracker import marginalization as marg
from dsopp_tpu_torch.tracker.fused_keyframe import immature_bank
from dsopp_tpu_torch.tracker.fused_tick import _initialization_hypotheses

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seq = render_sequence(num_frames=4, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    return seq


@pytest.mark.parametrize("levels", [5, 4])
def test_pyramid_kernel_matches_plain(scene, levels):
    """K1: one launch a pyramid, every level equal to the plain version's to
    the bit, on the scene's frame and on odd sizes (479x637, 121x161)."""
    gen = torch.Generator(device="cuda").manual_seed(levels)
    for img in (scene.images[1].contiguous(),
                torch.rand(479, 637, generator=gen, device="cuda") * 255,
                torch.rand(121, 161, generator=gen, device="cuda") * 255):
        before = kernels.PYRAMID.launches
        out = pyramid.build_pyramid_maps_cuda(img, levels)
        assert kernels.PYRAMID.launches == before + 1
        ref = pyramid.build_pyramid_maps_plain(img, levels)
        assert len(out) == levels
        for a, b in zip(out, ref):
            assert a.shape == b.shape and a.is_contiguous()
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="too small"):
        pyramid.build_pyramid_maps_cuda(torch.zeros(30, 30, device="cuda"), 5)


def test_align_kernel_matches_plain(scene):
    rng = np.random.default_rng(0)
    maps = pyramid.build_pyramid_maps_cuda(scene.images[2].contiguous(), 2)
    n = 1500
    uv = torch.tensor(rng.uniform(8, [312, 232], size=(n, 2)), dtype=torch.float32, device="cuda")
    depth = scene.depths[0][uv[:, 1].long(), uv[:, 0].long()]
    pts = pa.LevelPoints(uv, (1.0 / depth).contiguous(),
                         scene.images[0][uv[:, 1].long(), uv[:, 0].long()].contiguous(),
                         torch.tensor(rng.random(n) < 0.9, device="cuda"))
    t_rel = scene.pose(2, torch.float32, "cuda").inverse() @ scene.pose(0, torch.float32, "cuda")
    xi = torch.tensor(rng.normal(size=(5, 6)) * 3e-3, dtype=torch.float32, device="cuda")
    hyp = SE3.exp(xi) @ SE3(t_rel.q.expand(5, 4), t_rel.t.expand(5, 3))
    aff = torch.tensor(rng.normal(size=(5, 2)) * [0.01, 1.0], dtype=torch.float32, device="cuda")
    ref = torch.tensor([0.01, -1.0], device="cuda")
    args = (pts, maps[0], scene.camera, hyp, aff, ref, torch.tensor(1.05, device="cuda"), 20.0)
    hk, bk, ek, nk = pa.residual_system_cuda(*args)
    hp, bp, ep, np_ = pa.residual_system_plain(*args)
    assert torch.equal(nk, np_) and int(nk.min()) > 100
    assert float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2))).max()) <= 1e-4
    assert float(((bk - bp).norm(dim=1) / bp.norm(dim=1)).max()) <= 1e-4
    assert float(((ek - ep).abs() / ep.abs()).max()) <= 1e-5


def _epipolar_case(scene):
    """Two banks of the scene's frame 0 (one of them traced, with wide
    intervals around the true depths) against frame 3, with different
    exposures and affines."""
    k = 2
    map0 = pyramid.build_pyramid_maps_cuda(scene.images[0].contiguous(), 1)[0]
    bank = immature_bank(map0, 400)
    uv = bank.uv.long()
    gt = 1.0 / scene.depths[0][uv[:, 1], uv[:, 0]]
    traced = bank._replace(idepth_min=(0.3 * gt).contiguous(), idepth_max=(3.0 * gt).contiguous(),
                           status=torch.zeros_like(bank.status),
                           traced=torch.ones_like(bank.traced))
    pts = de.ImmaturePoints(*(torch.stack(x).contiguous() for x in zip(bank, traced)))
    pose = scene.pose(3, torch.float32, "cuda")
    host = scene.pose(0, torch.float32, "cuda")
    target = pyramid.build_pyramid_maps_cuda(scene.images[3].contiguous(), 1)[0]
    return (pts, target, scene.camera, pose.q.contiguous(), pose.t.contiguous(),
            host.q.expand(k, 4).contiguous(), host.t.expand(k, 3).contiguous(),
            torch.tensor([[0.02, 1.0], [-0.01, -2.0]], device="cuda"),
            torch.tensor([0.01, 0.5], device="cuda"), torch.tensor(1.05, device="cuda"),
            torch.tensor([1.0, 1.0825], device="cuda"), 20.0)


def _epipolar_gates(args, energies=True):
    """K4 against the plain version: best sample on >= 99.9 % and status on
    >= 99.5 % of the active points, any valid sample equal, the refined
    energy 1e-4 relative where the winners agree; its outputs equal to the
    bit to the plain geometry and update on its own poses and sweep, its
    poses within ``KERNEL_POSE_ULPS`` of torch's composition."""
    run = parity.epipolar_run(args)
    act = run.inp.active
    n_act = int(act.sum())
    assert n_act > 100
    same = (run.sweep.best_idx == run.res_p.best_idx) & act
    assert float(same.sum()) >= 0.999 * n_act
    assert torch.equal(run.sweep.any_sample[act], run.res_p.any_sample[act])
    agree = (run.kernel.status == run.plain.status).reshape(-1) & act
    assert float(agree.sum()) >= 0.995 * n_act
    if energies:
        fin = same & torch.isfinite(run.res_p.refined_energy)
        e_k, e_p = run.sweep.refined_energy[fin], run.res_p.refined_energy[fin]
        assert float(((e_k - e_p).abs() / e_p.clamp(min=1.0)).max()) <= 1e-4
    chain = parity.epipolar_chain_differ(args, run)
    assert all(chain[name] == 0 for name in parity.EPIPOLAR_OUTPUTS), chain
    assert chain["pose_ulps"] <= parity.KERNEL_POSE_ULPS, chain
    for name in ("uv", "patch", "gradient", "valid"):
        assert getattr(run.kernel, name) is getattr(args[0], name)
    return run


def test_epipolar_kernel_matches_plain(scene):
    args = _epipolar_case(scene)
    before = kernels.EPIPOLAR.launches
    _epipolar_gates(args)
    assert kernels.EPIPOLAR.launches == before + 1


@pytest.mark.parametrize("window", ["small", "dense"])
def test_epipolar_kernel_on_windows(request, window):
    """K4 on a tracked window's banks (the small one and the dense operating
    point's 17 banks) against the next frame at its true pose."""
    if window == "small":
        tracker, maps = request.getfixturevalue("tracked")
        seq, frame = render_sequence(num_frames=8, height=240, width=320, dtype=torch.float32,
                                     device="cuda"), 6
    else:
        from dsopp_tpu_torch.testing.paths import INIT_FRAMES
        tracker, maps = request.getfixturevalue("dense_tracked")
        seq, frame = request.getfixturevalue("dense_sequence"), INIT_FRAMES + DENSE_KEYFRAMES
    args = parity.epipolar_args(tracker, maps[0], seq.pose(frame, torch.float32, "cuda"))
    _epipolar_gates(args, energies=False)


def test_epipolar_wrapper_refuses_bad_inputs(scene):
    args = _epipolar_case(scene)
    before = kernels.EPIPOLAR.launches
    with pytest.raises(ValueError, match="CUDA"):
        de.estimate_depths_cuda(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="shape"):
        de.estimate_depths_cuda(*args[:5], args[5][:1].contiguous(), *args[6:])
    with pytest.raises(ValueError, match="float32"):
        de.estimate_depths_cuda(*args[:7], args[7].double(), *args[8:])
    assert kernels.EPIPOLAR.launches == before


@pytest.fixture(scope="module")
def tracked():
    """A tracker bootstrapped on 6 known-pose frames at 240×320 (every second
    one a keyframe), and the next frame's pyramid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return align_trace.small_tracker()


def test_align_level_kernel_matches_plain(tracked):
    tracker, maps = tracked
    before = kernels.ALIGN_LEVEL.launches
    for level, args in align_trace.level_cases(*tracked):
        res_k, res_p, partings = align_trace.compare(args)
        err = parity.align_level_errors(res_k, res_p)
        # the pose of every hypothesis, but for those whose traces show the
        # rounding tie at which the two loops parted
        held = torch.ones_like(res_p.iterations, dtype=torch.bool)
        held[[p["hypothesis"] for p in partings if p["tie"]]] = False
        shown = [{k: p[k] for k in ("hypothesis", "pass", "kernel", "plain", "tie")}
                 for p in partings]
        assert int(res_p.num_valid.min()) > 50, level
        assert err["num_valid"] <= 5e-3 and err["energy"] <= 1e-3 and err["rmse"] <= 1e-3, err
        assert float(err["rotation"][held].max()) <= 1e-4, (level, shown)
        assert float(err["translation"][held].max()) <= 1e-4, (level, shown)
        assert int(res_k.iterations.max()) <= tracker.align_opts.max_iterations
        assert int(res_k.iterations.min()) >= 1
    assert kernels.ALIGN_LEVEL.launches == before + 3


# (level, hypotheses): the best base hypothesis at level 0, the 5 base ones
# and the 105 escalation hypotheses (the last of the 109) at level 1
ALIGN_COUNTS = {1: (0, 1), 5: (1, 5), 105: (1, -105)}


@pytest.mark.parametrize("count", sorted(ALIGN_COUNTS))
def test_align_level_kernel_is_deterministic(tracked, count):
    tracker, maps = tracked
    [(level, args)] = align_trace.level_cases(tracker, maps, [ALIGN_COUNTS[count]])
    assert args[3].q.shape[0] == count
    res_k, res_p, partings = align_trace.compare(args)     # with the traces
    err = parity.align_level_errors(res_k, res_p)
    held = torch.ones_like(res_p.iterations, dtype=torch.bool)
    held[[p["hypothesis"] for p in partings if p["tie"]]] = False
    assert err["num_valid"] <= 5e-3 and err["energy"] <= 1e-3 and err["rmse"] <= 1e-3, err
    if bool(held.any()):
        assert float(err["rotation"][held].max()) <= 1e-4, (level, partings)
        assert float(err["translation"][held].max()) <= 1e-4, (level, partings)
    before = kernels.ALIGN_LEVEL.launches
    bare = pa.align_level_cuda(*args)
    again = pa.align_level_cuda(*args)
    assert kernels.ALIGN_LEVEL.launches == before + 2
    assert parity.align_level_equal(bare, again)
    assert parity.align_level_equal(bare, res_k)             # the trace changes nothing
    trace = []
    pa.align_level_cuda(*args, trace=trace)
    trace_again = []
    pa.align_level_cuda(*args, trace=trace_again)
    assert torch.equal(trace[0].nan_to_num(-1.0), trace_again[0].nan_to_num(-1.0))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("k", [10, 17, 21])
def test_ba_solve_step_kernel_blocked_lu(card, k):
    n = 64
    win, sys, eps, idepth = parity.step_problem(k, n, k, "cuda")
    problem_64 = parity.step_problem_f64(win, sys, eps, idepth)
    opts = pba.PBAOptions()
    dead = ~win.frame_valid
    for lam in (1e-5, 1e-2):
        before = kernels.BA_SOLVE.launches
        out_k = pba._solve_step_cuda(win, sys, eps, idepth, lam, opts)
        again = pba._solve_step_cuda(win, sys, eps, idepth, lam, opts)
        assert kernels.BA_SOLVE.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(out_k, again))
        out_64 = pba._solve_step_plain(*problem_64, lam, opts)
        err = parity.solve_step_errors(out_k, out_64, eps, idepth)
        assert float((out_64[0] - eps.double()).abs().max()) > 0
        assert err["step"] <= 1e-4 and err["d_step"] <= 1e-4, err
        assert torch.equal(out_k[0][dead], eps[dead])
        # the loop-state mode: λ from the state; a finished loop writes nothing
        state = torch.zeros(pba.LM_FIELDS, dtype=torch.int32, device="cuda")
        state[pba.LM_LAMBDA] = int(torch.tensor([lam]).view(torch.int32)[0])
        buffers = pba._solve_step_buffers(k, n, torch.float32, "cuda")
        eps_s, idepth_s, sq_s = pba._solve_step_launch(win, sys, eps, idepth, None, state,
                                                       buffers=buffers)
        assert torch.equal(eps_s, out_k[0]) and torch.equal(idepth_s, out_k[1])
        assert torch.equal(sq_s, torch.stack([out_k[2], out_k[3]]))
        state[pba.LM_DONE] = 1
        for b in buffers[2:]:
            b.fill_(7.0)
        pba._solve_step_launch(win, sys, eps, idepth, None, state, buffers=buffers)
        assert all(bool((b == 7.0).all()) for b in buffers[2:])
    # no ledger and no Schur term: the assembly is exact on both sides, and
    # the step is the column-by-column LU's (the kernel's pivots and order)
    exact = parity.exact_step_problem(k, n, k, "cuda")
    step_u, pivots_u = parity.unblocked_step(*exact[:3], 1e-5)
    assert sum(p != i for i, p in enumerate(pivots_u)) > 4 * k
    assert torch.equal(pba._solve_step_cuda(*exact, 1e-5, opts)[0], step_u)
    with pytest.raises(ValueError):
        pba._solve_step_cuda(*parity.step_problem(22, 8, 0, "cuda"), 1e-5, opts)


def _ba_problem(tracker):
    """The tracker's window moved off its linearization point."""
    win = tracker.window
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, n = win.num_slots, win.num_landmark_slots
    scale = torch.tensor([1e-3] * 6 + [5e-3, 0.3], device="cuda")
    eps = torch.randn((k, 8), generator=gen, device="cuda") * scale
    eps = torch.where(win.frame_valid[:, None] & ~win.frame_fixed[:, None], eps,
                      torch.zeros_like(eps))
    idepth = win.lm_idepth * (1.0 + 0.01 * torch.randn((k, n), generator=gen, device="cuda"))
    return win, eps.contiguous(), idepth.contiguous(), pba.active_lm_mask(win)


def test_ba_evaluate_kernel_matches_plain(tracked):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    args = (win, tracker.models[0], eps, idepth, lm_mask, tracker.pba_opts)
    ev_k = pba._evaluate_cuda(*args)
    ev_p = pba._evaluate_plain(*args)
    live = pba._pair_mask(win)[:, :, None] & lm_mask[:, None, :]
    err = parity.evaluation_errors(ev_k, ev_p, live)
    assert err["ok"] > 100 and err["agree"] >= 0.999, err
    assert max(err[name] for name in ("residuals", "gx", "gy", "energy_patch", "weight")) <= 1e-4, err


DENSE_KEYFRAMES = 12      # known-pose keyframes past the bootstrap on the dense window


@pytest.fixture(scope="module")
def dense_sequence():
    """The VGA corridor of the dense path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.testing.paths import render_path
    return render_path("dense")


@pytest.fixture(scope="module")
def dense_tracked(dense_sequence):
    """The dense operating point (dense.yaml: 17 slots × 340 landmarks) on the
    VGA corridor after 12 known-pose keyframes past the bootstrap, and the
    next frame's pyramid."""
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, bootstrap, path_config
    seq = dense_sequence
    tracker = bootstrap(seq, path_config("dense"))
    for i in range(INIT_FRAMES, INIT_FRAMES + DENSE_KEYFRAMES):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=seq.pose(i, torch.float32), force_keyframe=True)
    maps = pyramid.build_pyramid_maps(seq.images[INIT_FRAMES + DENSE_KEYFRAMES].contiguous(),
                                      tracker.config.pyramid_levels)
    return tracker, maps


WINDOWS = {"small": "tracked", "dense": "dense_tracked"}


@pytest.mark.parametrize("marg_pass", [False, True])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_ba_linearize_kernel_matches_plain(request, window, marg_pass):
    """K8 with its FEJ formed inside from the window, against the plain
    version on ``_fej_cache_plain``; one launch of K8's entry, no cache."""
    tracker, _ = request.getfixturevalue(WINDOWS[window])
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    model, opts = tracker.models[0], tracker.pba_opts
    fej = pba._fej_cache_plain(win, model)
    assert int(fej.geom_valid.sum()) > 100
    ev = pba._evaluate_plain(win, model, eps, idepth, lm_mask, opts)
    before = kernels.counts()
    sys_k = pba._linearize_from_ev_cuda(win, model, ev, eps, opts, marg_pass)
    launched = {name: n - before[name] for name, n in kernels.counts().items() if n != before[name]}
    assert launched == {"ba_linearize_schur": 1}
    sys_p = pba._linearize_from_ev_plain(win, fej, ev, eps, opts, marg_pass)
    err = parity.linear_system_errors(sys_k, sys_p)
    assert float(sys_p.h_schur.abs().max()) > 0
    assert max(err.values()) <= 1e-4, err
    again = pba._linearize_from_ev_cuda(win, model, ev, eps, opts, marg_pass)
    assert all(torch.equal(a, b) for a, b in zip(sys_k, again))     # two runs, the same bits
    assert all(torch.equal(a, b) for a, b in
               zip(sys_k, pba._linearize_from_ev(win, model, ev, eps, opts, marg_pass)))


def test_fej_cache_refuses_the_card(tracked):
    """The card keeps no FEJ cache: ``_fej_cache`` raises on a CUDA window."""
    tracker, _ = tracked
    with pytest.raises(ValueError, match="K8"):
        pba._fej_cache(tracker.window, tracker.models[0])


def test_flow_kernel_matches_plain(tracked):
    """K5's flows alone (the bootstrap's mode, its decision inputs null) and
    with the decision: one launch each, the flows 1e-5 relative of the plain
    version's and equal to the bit in both modes."""
    tracker, _ = tracked
    kf = tracker._kf_pose()
    hyp = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, False)
    t_t_kf = SE3(hyp.q[0], hyp.t[0]).inverse() @ kf
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    before = kernels.FLOW.launches
    out_k = dm.mean_square_flows_cuda(tracker.flow_points, tracker.models[0], t_t_kf)
    out_p = dm.mean_square_flows_plain(tracker.flow_points, tracker.models[0], t_t_kf)
    assert kernels.FLOW.launches == before + 1
    assert float(out_p[0]) > 0 and float(out_p[1]) > 0
    assert parity.rel_max(out_k[0], out_p[0]) <= 1e-5
    assert parity.rel_max(out_k[1], out_p[1]) <= 1e-5
    args = _statistics_args(tracker, t_t_kf, 1.0, 1.0, 0.5, 50, 1.25, False)
    stats = _no_host_reads(dm.frame_statistics_cuda, *args)
    assert kernels.FLOW.launches == before + 2
    assert torch.equal(stats[:2], torch.stack(out_k))


def _statistics_args(tracker, t_t_kf, rmse, rmse_last0, kf_rmse, num_valid, factor, force):
    f32 = dict(dtype=torch.float32, device="cuda")
    return (tracker.flow_points, tracker.models[0], t_t_kf,
            t_t_kf.inverse().matrix().contiguous(), torch.tensor(rmse, **f32),
            torch.tensor(num_valid, dtype=torch.int32, device="cuda"),
            torch.tensor(rmse_last0, **f32), torch.tensor(kf_rmse, **f32), factor, force)


# (rmse, rmse_last0, kf_rmse, num_valid, force): reliable or not, the strategy
# memory unset or set on either side of MAX_EXCESS_ENERGY, no valid point, forced
DECISION_CASES = [(1.0, 1.0, 0.5, 50, False), (1.0, 1.0, 0.2, 50, False),
                  (1.0, 1.0, 0.25, 50, False), (1.0, 1.0, -1.0, 50, False),
                  (3.0, 1.0, 0.2, 50, False), (1.0, 1.0, 0.2, 0, False),
                  (1.0, 1.0, 0.5, 50, True), (2.5, 1.0, 0.5, 50, False)]


@pytest.mark.parametrize("case", range(len(DECISION_CASES)))
def test_flow_decision_kernel_matches_plain(tracked, case):
    """K5 with the gate and the decision: the flows 1e-5 relative of the plain
    version's; the gate, the state's next rmse_last0 and kf_rmse, the
    decision, the rmse and the frame's matrix equal to the bit to the torch
    decision on the kernel's flows (``keyframe_decision_plain`` on the card),
    at the paths' factors and at the one that puts the flow term on the
    threshold; one launch with no host read, the caller's tensors untouched,
    two runs equal to the bit."""
    tracker, _ = tracked
    kf = tracker._kf_pose()
    t_t_kf = SE3(tracker.t_w_last.q, tracker.t_w_last.t).inverse() @ kf
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    rmse, rmse_last0, kf_rmse, num_valid, force = DECISION_CASES[case]
    flows = dm.mean_square_flows_cuda(tracker.flow_points, tracker.models[0], t_t_kf)
    edge = 1.0 / (dm.MAX_SHIFT_WEIGHT * float(flows[0])
                  + dm.MAX_SHIFT_NO_ROT_WEIGHT * float(flows[1]))
    for factor in (1.25, 2.0, 3.0, edge):
        args = _statistics_args(tracker, t_t_kf, rmse, rmse_last0, kf_rmse, num_valid, factor,
                                force)
        kept = [x.clone() for x in args[3:8]]
        before = kernels.FLOW.launches
        stats = _no_host_reads(dm.frame_statistics_cuda, *args)
        assert kernels.FLOW.launches == before + 1
        assert stats.shape == (dm.STATS,) and stats.dtype == torch.float32
        assert all(torch.equal(a, b) for a, b in zip(args[3:8], kept))
        plain = dm.frame_statistics_plain(*args)
        assert parity.rel_max(stats[0], plain[0]) <= 1e-5
        assert parity.rel_max(stats[1], plain[1]) <= 1e-5
        want = dm.keyframe_decision_plain(stats[0], stats[1], *args[4:])
        got = (stats[dm.STAT_RELIABLE] != 0, stats[dm.STAT_RMSE_LAST0], stats[dm.STAT_KF_RMSE],
               stats[dm.STAT_NEED] != 0)
        assert all(torch.equal(a, b.reshape(())) for a, b in zip(got, want)), (factor, got, want)
        assert torch.equal(stats[dm.STAT_MATRIX:], args[3].reshape(16))
        assert float(stats[dm.STAT_RMSE]) == rmse
        assert torch.equal(stats, dm.frame_statistics_cuda(*args))


@pytest.mark.parametrize("lam", [1e-5, 1e-2])
def test_ba_solve_step_kernel_matches_plain(tracked, lam):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts = tracker.pba_opts
    fej = pba._fej_cache_plain(win, tracker.models[0])
    ev = pba._evaluate_plain(win, tracker.models[0], eps, idepth, lm_mask, opts)
    sys = parity.contiguous(pba._linearize_from_ev_plain(win, fej, ev, eps, opts))
    out_k = pba._solve_step_cuda(win, sys, eps, idepth, lam, opts)
    out_64 = pba._solve_step_plain(parity.to_f64(win), parity.to_f64(sys), eps.double(),
                                   idepth.double(), lam, opts)
    err = parity.solve_step_errors(out_k, out_64, eps, idepth)
    assert float((out_64[0] - eps.double()).abs().max()) > 0
    assert err["step"] <= 1e-4 and err["d_step"] <= 1e-4, err


@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_ba_lm_loop_matches_host_driven_loop(tracked, ledger):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    sys = pba._linearize_from_ev(win, model, pba._evaluate(win, model, eps, idepth, lm_mask, opts),
                                 eps, opts)
    if ledger == "filled":
        win = parity.scaled_ledger(win, sys)
    else:
        win = win.replace(h_marg=torch.zeros_like(win.h_marg),
                          b_marg=torch.zeros_like(win.b_marg),
                          energy_marg=torch.zeros_like(win.energy_marg))
    log_k, log_p = [], []
    res_k = pba._solve_loop_cuda(win, model, opts, log=log_k)
    res_p = pba._solve_loop_plain(win, model, opts, log=log_p)
    err = parity.solve_loop_errors(res_k, res_p, log_k, log_p)
    assert err["same_flags"], (log_k, log_p)
    assert (err["relins"] > 0) == (ledger == "empty")
    assert err["energy"] <= 1e-4 and err["rotation"] <= 1e-4 and err["translation"] <= 1e-4, err
    assert err["status_agree"] >= 0.999, err
    # the device-resident loop reads nothing on the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        pba._solve_loop_device(win, model, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_ba_point_status_kernel_matches_plain(tracked):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    ps_k = pba._point_status_from_ev_cuda(win, ev, lm_mask, opts)
    ps_p = pba._point_status_from_ev_plain(win, ev, lm_mask, opts)
    err = parity.point_status_errors(ps_k, ps_p, ev)
    assert int((ps_p.res_status == pba.RES_OUTLIER).sum()) > 0
    assert err["threshold"] <= 1e-6, err
    assert err["status_differ"] == err["inliers_differ"] == err["flags_differ"] == 0, err
    assert err["baseline"] <= 1e-6, err


def _ledger_case(win, model, opts, eps, idepth, lm_mask, ledger):
    """``win`` with an empty ledger, or a filled one of its own scale."""
    if ledger == "filled":
        ev = pba._evaluate(win, model, eps, idepth, lm_mask, opts)
        return parity.scaled_ledger(win, pba._linearize_from_ev(win, model, ev, eps, opts))
    return win.replace(h_marg=torch.zeros_like(win.h_marg), b_marg=torch.zeros_like(win.b_marg),
                       energy_marg=torch.zeros_like(win.energy_marg))


@pytest.mark.parametrize("ledger", ["empty", "filled"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_one_call_solve_matches_plain_loop(request, window, ledger):
    """The whole solve in one C call (``ba_solve_loop``) against the
    host-driven plain loop under K10's gates; the fixed sequence's launches
    added to K7-K11's counts; two calls equal to the bit."""
    tracker, _ = request.getfixturevalue(WINDOWS[window])
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = _ledger_case(win.replace(eps=eps, lm_idepth=idepth), model, opts, eps, idepth,
                       lm_mask, ledger)
    before = kernels.counts()
    log_k, log_p = [], []
    res_k = pba._solve_loop_cuda(win, model, opts, log=log_k)
    launched = {name: n - before[name] for name, n in kernels.counts().items()
                if n != before[name]}
    assert launched == {**pba.solve_loop_launches(opts.max_iterations), "ba_solve_loop": 1}
    res_p = pba._solve_loop_plain(win, model, opts, log=log_p)
    err = parity.solve_loop_errors(res_k, res_p, log_k, log_p)
    assert err["same_flags"], (log_k, log_p)
    assert err["accepts"] >= 1 and (err["relins"] > 0) == (ledger == "empty"), err
    assert err["energy"] <= 1e-4 and err["log_energy"] <= 1e-4, err
    assert err["rotation"] <= 1e-4 and err["translation"] <= 1e-4, err
    assert err["status_agree"] >= 0.999, err
    again = pba._solve_loop_cuda(win, model, opts)
    for name in ("t_lin_q", "t_lin_t", "affine0", "eps", "lm_idepth", "res_status",
                 "lm_baseline", "lm_inliers", "lm_outlier", "lm_opt_count"):
        assert torch.equal(getattr(res_k[0], name), getattr(again[0], name)), name
    assert torch.equal(res_k[1], again[1]) and torch.equal(res_k[2], again[2])


@pytest.mark.parametrize("ledger", ["empty", "filled"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_sharded_solve_on_one_lm_rank_is_the_one_call_solve(request, window, ledger):
    """The landmark-sharded solve's Python-issued sequence on a mesh of one
    ``lm`` rank (no collective): the one C call's launches, its LM log and
    its outputs to the bit, with no host read."""
    from dsopp_tpu_torch.parallel.mesh import make_mesh
    from dsopp_tpu_torch.parallel.shard_map_ba import _solve_loop_issued

    tracker, _ = request.getfixturevalue(WINDOWS[window])
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = _ledger_case(win.replace(eps=eps, lm_idepth=idepth), model, opts, eps, idepth,
                       lm_mask, ledger)
    log_c, log_s = [], []
    want = pba._solve_loop_cuda(win, model, opts, log=log_c)
    before = kernels.counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _solve_loop_issued(win, model, opts, make_mesh(1, 1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = {name: n - before[name] for name, n in kernels.counts().items()
                if n != before[name]}
    assert launched == pba.solve_loop_launches(opts.max_iterations)
    _solve_loop_issued(win, model, opts, make_mesh(1, 1), log=log_s)
    assert log_s == log_c
    for f in ("t_lin_q", "t_lin_t", "affine0", "eps", "lm_idepth", "res_status",
              "lm_baseline", "lm_inliers", "lm_outlier", "lm_opt_count"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_ba_lm_reduced_sums_decide_alike(tracked, ledger):
    """K10 given the trial's landmark sums (as a sharded solve all-reduces
    them, here the unsharded sums in f64) against K10 summing the trial
    itself: the same decisions and committed state; the energy the same f32
    value but for the association of an f64 sum (one ulp at most)."""
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = _ledger_case(win.replace(eps=eps, lm_idepth=idepth), model, opts, eps, idepth,
                       lm_mask, ledger)
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    sys = pba._linearize_from_ev_cuda(win, model, ev, eps, opts)
    eps_new, idepth_new, step_sq = pba._solve_step_launch(win, sys, eps, idepth,
                                                          opts.initial_regularizer, None)
    ev_new = pba._evaluate_cuda(win, model, eps_new, idepth_new, lm_mask, opts)

    def sums(e):
        return torch.stack([e.sum(dtype=torch.float64), (e > 0).sum(dtype=torch.float64)])

    runs = []
    for reduced in (None, (sums(ev.energy_patch), sums(ev_new.energy_patch))):
        carried = pba._carried_state(win)
        state = torch.empty(pba.LM_FIELDS, dtype=torch.int32, device="cuda")
        lm_log = torch.empty((2, pba.LM_FIELDS), dtype=torch.int32, device="cuda")
        pba._lm_phase(0, 0, win, opts, eps, idepth, None, ev, ev_new, carried, state, lm_log,
                      reduced=None if reduced is None else reduced[0])
        pba._lm_phase(1, 1, win, opts, eps_new, idepth_new, step_sq, ev, ev_new, carried,
                      state, lm_log, reduced=None if reduced is None else reduced[1])
        runs.append((carried, pba.lm_log_rows(lm_log)))
    (c_own, log_own), (c_red, log_red) = runs
    assert log_own[-1]["accept"]
    for a, b in zip(log_own, log_red):
        assert {k: v for k, v in a.items() if k != "energy"} == \
            {k: v for k, v in b.items() if k != "energy"}
        assert abs(a["energy"] - b["energy"]) <= 1.2e-7 * abs(a["energy"]), (a, b)
    assert all(torch.equal(x, y) for x, y in zip(c_own, c_red))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_ba_point_status_threshold_across_two_shards(request, window):
    """K11 on the evaluation and the landmark fields of two shards gathered
    as a sharded solve gathers them (each shard packed as bits into its
    slice, the buffers summed) equals K11 on the whole evaluation to the
    bit: the threshold and every output."""
    from dsopp_tpu_torch.parallel.shard_map_ba import pack_shards, unpack_shards

    tracker, _ = request.getfixturevalue(WINDOWS[window])
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    whole = pba._point_status_from_ev_cuda(win, ev, lm_mask, opts)
    fields = (ev.energy_patch, ev.ok, ev.status_candidate, lm_mask, win.lm_idepth,
              win.lm_baseline, win.lm_outlier, win.lm_opt_count)
    n = win.num_landmark_slots // 2
    shards = [[x[..., i * n:(i + 1) * n].contiguous() for x in fields] for i in range(2)]
    flat = pack_shards(shards[0], 0, 2) + pack_shards(shards[1], 1, 2)
    energy, ok, cand, mask, idep, baseline, outlier, opt_count = unpack_shards(flat, shards[0], 2)
    got = pba._point_status_from_ev_cuda(
        win.replace(lm_idepth=idep, lm_baseline=baseline, lm_outlier=outlier,
                    lm_opt_count=opt_count),
        ev._replace(energy_patch=energy, ok=ok, status_candidate=cand), mask, opts)
    assert int((whole.res_status == pba.RES_OUTLIER).sum()) > 0
    for name, a, b in zip(pba.PointStatus._fields, got, whole):
        assert torch.equal(a, b), name


def test_one_call_solve_wrapper_allocates_and_calls_once(tracked, monkeypatch):
    """Under the profiler the wrapper runs no torch operator but
    allocations, and it makes one C call (``ba_solve_loop``): no other
    kernel entry is called from Python."""
    tracker, _ = tracked
    win, eps, idepth, _ = _ba_problem(tracker)
    win, model, opts = win.replace(eps=eps, lm_idepth=idepth), tracker.models[0], tracker.pba_opts
    pba._solve_loop_cuda(win, model, opts)
    assert _aten_ops(pba._solve_loop_cuda, win, model, opts) <= ALLOCATION_OPS
    calls, call = [], kernels.Kernel.__call__

    def recorded(self, *args):
        calls.append(self.name)
        return call(self, *args)

    monkeypatch.setattr(kernels.Kernel, "__call__", recorded)
    pba._solve_loop_cuda(win, model, opts)
    assert calls == ["ba_solve_loop"]


def test_one_call_solve_reads_nothing_on_the_host(dense_tracked):
    """The one-call solve with every host synchronisation an error, at the
    dense operating point, with the window's own ledger."""
    tracker, _ = dense_tracked
    win, eps, idepth, _ = _ba_problem(tracker)
    win, model, opts = win.replace(eps=eps, lm_idepth=idepth), tracker.models[0], tracker.pba_opts
    res, energy, count = _no_host_reads(pba._solve_loop_cuda, win, model, opts)
    assert int(count) > 0 and bool(torch.isfinite(energy))
    assert bool(torch.isfinite(res.eps).all())


def _no_host_reads(fn, *args, **kwargs):
    """``fn`` with every host synchronisation an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("masked,num_points", [(False, 400), (True, 400), (False, 5000)])
def test_candidates_kernel_matches_plain(scene, masked, num_points):
    maps = pyramid.build_pyramid_maps_cuda(scene.images[1].contiguous(), 1)[0]
    mask = None
    if masked:
        mask = torch.ones(maps.shape[1:], dtype=torch.bool, device="cuda")
        mask[180:] = False
        mask[:, ::7] = False
    before = kernels.SELECT_CANDIDATES.launches
    out_k = _no_host_reads(extractor.select_candidates_cuda, maps, num_points, mask)
    out_p = extractor.select_candidates_plain(maps, num_points, mask)
    assert kernels.SELECT_CANDIDATES.launches == before + 1
    err = parity.candidates_errors(out_k, out_p)
    assert err["valid"] > 100 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
    assert err["grad2"] == 0.0, err
    if masked:
        uv = out_k.uv[out_k.valid]
        assert float(uv[:, 1].max()) < 180 and bool((uv[:, 0].long() % 7 != 0).all())


@pytest.mark.parametrize("constant", [False, True])
def test_candidates_kernel_ragged_size_and_ties(constant):
    """100×150 (3.125 × 4.69 regions, tile 5) with a random mask; with a
    constant gradient every allowed pixel scores the same, so the order is
    that of the tile indices alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    h, w = 100, 150
    dx, dy = (np.full((h, w), 0.6), np.full((h, w), -0.5)) if constant else \
        (rng.normal(0, 20, (h, w)), rng.normal(0, 20, (h, w)))
    maps = torch.tensor(np.stack([rng.uniform(0, 255, (h, w)), dx, dy]), dtype=torch.float32,
                        device="cuda")
    mask = torch.tensor(rng.random((h, w)) < 0.6, device="cuda")
    for num_points in (300, 5000):          # 5000: more slots than the 50 x 75 tiles of 2 x 2
        out_k = extractor.select_candidates_cuda(maps, num_points, mask)
        out_p = extractor.select_candidates_plain(maps, num_points, mask)
        err = parity.candidates_errors(out_k, out_p)
        assert err["valid"] > 50 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
        assert err["grad2"] == 0.0, err


@pytest.fixture(scope="module")
def keyframe(tracked):
    """The tracker's window with the next frame pushed as its newest keyframe,
    and the banks before activation."""
    tracker, _ = tracked
    seq = render_sequence(num_frames=8, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    return (tracker,) + parity.keyframe_case(tracker, seq.images[6],
                                             seq.pose(6, torch.float32, "cuda"), 6)


@pytest.fixture(scope="module")
def dense_keyframe(dense_tracked, dense_sequence):
    """The dense window with the next frame pushed as its newest keyframe, and
    the banks before activation."""
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES
    tracker, _ = dense_tracked
    frame = INIT_FRAMES + DENSE_KEYFRAMES
    return (tracker,) + parity.keyframe_case(tracker, dense_sequence.images[frame],
                                             dense_sequence.pose(frame, torch.float32, "cuda"),
                                             frame)


KEYFRAMES = {"small": "keyframe", "dense": "dense_keyframe"}
ALLOCATION_OPS = {"aten::empty", "aten::empty_strided"}


def _aten_ops(fn, *args):
    """The aten operators ``fn(*args)`` runs on the host."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(*args)
    torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.name.startswith("aten::")}


@pytest.mark.parametrize("window", list(KEYFRAMES))
def test_activation_kernel_matches_plain(request, window):
    tracker, win, imm, _ = request.getfixturevalue(KEYFRAMES[window])
    model = tracker.models[0]
    min_distance = torch.tensor(1.5, device="cuda")
    before = kernels.ACTIVATION.launches
    res_k = _no_host_reads(act._activation_cuda, win, model, imm, min_distance)
    res_p = act._activation_plain(win, model, imm, min_distance)
    assert kernels.ACTIVATION.launches == before + 1
    terms = act._activation_terms_plain(win, model, imm)
    err = parity.activation_errors(res_k, res_p, terms, min_distance, model)
    assert err["n_active"] > 50 and err["activate"] > 20, err
    assert err["n_active_differ"] == 0 and err["agree"] >= 0.999 and err["unexplained"] == 0, err
    # two runs equal to the bit; the wrapper runs no torch operator but allocations
    again = act._activation_cuda(win, model, imm, min_distance)
    assert all(torch.equal(a, b) for a, b in zip(res_k, again))
    assert _aten_ops(act._activation_cuda, win, model, imm, min_distance) <= ALLOCATION_OPS
    # no active landmark: every ready, valid candidate is spaced
    empty = win.replace(lm_valid=torch.zeros_like(win.lm_valid))
    res_k, res_p = (fn(empty, model, imm, 1.5) for fn in (act._activation_cuda,
                                                         act._activation_plain))
    assert int(res_k[2]) == 0 and int(res_p[0].sum()) > err["activate"]
    assert int((res_k[0] != res_p[0]).sum()) <= 1e-3 * res_p[0].numel()
    # an idepth of 0 and a point behind the camera: invalid reprojections
    odd = imm._replace(idepth_min=imm.idepth_min.clone(), idepth_max=imm.idepth_max.clone())
    odd.idepth_min[0, :8], odd.idepth_max[0, :8] = 0.0, 0.0
    odd.idepth_min[0, 8:16], odd.idepth_max[0, 8:16] = 900.0, 1100.0
    res_k, res_p = (fn(win, model, odd, min_distance) for fn in (act._activation_cuda,
                                                                 act._activation_plain))
    assert torch.equal(res_k[0][0, :16], res_p[0][0, :16])
    assert torch.equal(res_k[1][0, :16], res_p[1][0, :16])


@pytest.mark.parametrize("cap", [act.REFINE_CAP, 24])
@pytest.mark.parametrize("window", list(KEYFRAMES))
def test_refine_and_scatter_kernels_match_plain(request, window, cap):
    keyframe = request.getfixturevalue(KEYFRAMES[window])
    tracker, win, imm, _ = keyframe
    model = tracker.models[0]
    activate, delete, _ = act._activation_plain(win, model, imm, 1.5)
    trace_k, trace_p = [], []
    before = kernels.REFINE.launches
    out_k = _no_host_reads(act._refine_idepth_cuda, win, model, imm, activate, 20.0, cap,
                           trace_k)
    out_p = act._refine_idepth_plain(win, model, imm, activate, 20.0, cap, trace_p)
    assert kernels.REFINE.launches == before + 1
    err = parity.refine_errors(out_k, out_p, trace_k[0], trace_p[0])
    assert err["selected"] == min(cap, int(activate.sum())) > 0 and err["selected_differ"] == 0, err
    assert err["keep"] > 0 and err["accepts"] > 0 and err["kept_outside_selected"] == 0, err
    assert err["keep_agree"] >= 0.995 and err["idepth"] <= 1e-4, err
    assert err["parted_others"] <= 0.005 * err["selected"], err
    # two runs equal to the bit (the trace too, zero rows past the refined
    # ones); the wrapper runs no torch operator but allocations
    trace_again = []
    again = act._refine_idepth_cuda(win, model, imm, activate, 20.0, cap, trace_again)
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    assert torch.equal(trace_k[0], trace_again[0])
    assert not bool(trace_k[0][err["selected"]:].any())
    assert _aten_ops(act._refine_idepth_cuda, win, model, imm, activate, 20.0, cap) <= ALLOCATION_OPS
    # the pairing with the refinement's glue inside, on the plain version's
    # refinement, against the plain entry; and without a refinement
    idepth, keep, selected = out_p
    # leave the newest host only a few free slots, so that take = #free there
    host = int(torch.argmax(keep.sum(dim=1)))
    lm_valid = win.lm_valid.clone()
    lm_valid[host, 5:] = True
    full = win.replace(lm_valid=lm_valid)
    kept = [x.clone() for x in (win.lm_uv, win.lm_patch, win.lm_idepth, win.lm_valid,
                                win.res_status, imm.valid, imm.idepth_min, imm.idepth_max)]
    before = kernels.ACTIVATION_SCATTER.launches
    for window in (win, full):
        for args in ((window, imm, keep, delete, idepth, selected),
                     (window, imm, activate, delete)):
            res_k = _no_host_reads(act._activation_scatter_cuda, *args)
            res_p = act._activation_scatter_plain(*args)
            err = parity.scatter_errors(res_k, res_p)
            assert err.pop("n_activated") > 0
            assert not any(err.values()), err
            assert torch.equal(res_k[1].idepth_min, res_p[1].idepth_min)
            assert torch.equal(res_k[1].idepth_max, res_p[1].idepth_max)
            assert res_k[2].shape == () and res_k[2].dtype == torch.int64
            assert all(getattr(res_k[0], name).is_contiguous()
                       for name in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status"))
    assert kernels.ACTIVATION_SCATTER.launches == before + 4
    # the caller's window and banks are untouched
    assert all(torch.equal(a, b) for a, b in
               zip(kept, (win.lm_uv, win.lm_patch, win.lm_idepth, win.lm_valid, win.res_status,
                          imm.valid, imm.idepth_min, imm.idepth_max)))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_frontend_state_kernel_matches_plain(request, window):
    tracker, maps = request.getfixturevalue(WINDOWS[window])
    win, model = tracker.window, tracker.models[0]
    h, w = tracker.image_shape
    cfg = tracker.config
    boundary = parity.pixel_boundary_landmarks(win, model)
    win = win.replace(lm_valid=win.lm_valid & ~boundary)
    args = (win, model, tuple(maps), h, w, cfg.pyramid_levels, cfg.frontend_points)
    before = kernels.DEPTH_MAPS.launches
    out_k = _no_host_reads(dm.build_frontend_state_cuda, *args)
    assert kernels.DEPTH_MAPS.launches == before + 1
    # the call's device work as the entry counts it
    assert dm.last_call["kernels"] <= 16 and dm.last_call["memsets"] == 0, dm.last_call
    out_p = dm.build_frontend_state_plain(*args)
    err = parity.frontend_errors(out_k, out_p)
    assert err["positive"][0] > 100 and min(err["valid"]) > 50, err
    assert err["weight_differ"] == 0 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
    assert err["idepth_map"] <= 1e-6 and err["idepth"] <= 1e-6 and err["intensity"] == 0.0, err
    # the coarsest level pads the slots it has no pixels for; two runs give
    # the same bits
    cells = out_k[1][-1].numel()
    assert cells < cfg.frontend_points and not bool(out_k[2][-1].valid[cells:].any())
    again = dm.build_frontend_state_cuda(*args)
    assert all(torch.equal(x, y) for x, y in zip(_frontend_tensors(out_k),
                                                 _frontend_tensors(again)))


def _frontend_tensors(out):
    """Every tensor of build_frontend_state's result."""
    idep, wei, points, flow = out
    return [*idep, *wei, *(t for pts in (*points, flow) for t in pts)]


@pytest.fixture(scope="module")
def marg_windows(tracked):
    """The tracker's window off its linearization point, with an empty and
    with a filled ledger."""
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    sys = pba._linearize_from_ev(win, model, pba._evaluate(win, model, eps, idepth, lm_mask, opts),
                                 eps, opts)
    empty = win.replace(h_marg=torch.zeros_like(win.h_marg), b_marg=torch.zeros_like(win.b_marg),
                        energy_marg=torch.zeros_like(win.energy_marg))
    return {"empty": empty, "filled": parity.scaled_ledger(win, sys)}


@pytest.mark.parametrize("case", parity.MARG_CASES)
@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_marg_fold_kernel_matches_plain(tracked, marg_windows, ledger, case):
    """K15: the new ledger within ``parity.LEDGER_TOL`` of its largest entry
    (``parity.ledger_check``); the Jacobi solver converged; two runs equal to
    the bit; the window it leaves as the plain version's; no host read."""
    tracker, _ = tracked
    opts, model = tracker.pba_opts, tracker.models[0]
    start = marg_windows[ledger]
    slots = parity.marg_cases(start)[case]
    w, perm = parity.marg_case(start, case, slots, torch.Generator(device="cuda").manual_seed(1))
    raw = _marg_raw(w, model, perm, opts)
    fold = (w, *pba._points_system(*raw[:5], opts), raw[5], perm, opts)
    before = kernels.MARG_FOLD.launches
    sweeps = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    out_k = _no_host_reads(pba._marginalize_cuda, *raw, sweeps)
    assert kernels.MARG_FOLD.launches == before + 1
    err = parity.ledger_check(out_k, fold)
    assert err["eigenvalues"] == 8 * len(slots)
    if case == "a dead frame" and ledger == "empty":
        assert err["dropped"] == 6, err         # only the two affine priors are kept
    assert err["within"], err
    assert 0 <= int(sweeps) < pba.MARG_MAX_SWEEPS
    assert slots or int(sweeps) == 0
    assert all(torch.equal(a, b) for a, b in zip(out_k, pba._marginalize_cuda(*raw)))
    win_k = _no_host_reads(pba._marginalize_device, w, model, perm, opts)
    win_p = pba._marginalize_with(pba._marginalize_system_plain, w, model, perm, opts)
    for name in ("frame_valid", "frame_id", "lm_valid", "lm_marg_flag"):
        assert torch.equal(getattr(win_k, name), getattr(win_p, name)), name


def _marg_raw(w, model, perm, opts):
    """K15's arguments: K8's marginalization-pass system of ``w`` raw."""
    sys_m, e_land = pba._marg_pass(w, model, opts)
    return (w, sys_m.h_pose, sys_m.b_pose, sys_m.h_schur, sys_m.b_schur, e_land, perm, opts)


def test_marg_policy_kernel_matches_plain(tracked, marg_windows):
    """K15p: flags, outliers and the permutation equal to the plain version's
    (``parity.policy_errors``) at the tracker's window sizes and with the
    window one frame too large; no host read."""
    tracker, _ = tracked
    cfg = tracker.config
    win = marg_windows["filled"]
    frames = int(win.frame_valid.sum())
    flagged = 0
    for lo, hi in ((cfg.window_min, cfg.window_max), (min(cfg.window_min, frames - 2), frames - 1)):
        args = (win, tracker.immature.valid, lo, hi, cfg.max_marginalized_fraction)
        before = kernels.MARG_POLICY.launches
        out_k = _no_host_reads(marg.flags_device_cuda, *args)
        assert kernels.MARG_POLICY.launches == before + 1
        out_p = marg.flags_device_plain(*args)
        err = parity.policy_errors(out_k, out_p, win, lo, hi)
        assert err["explained"], err
        flagged += err["frames_flagged"]
        assert all(torch.equal(a, b) for a, b in zip(out_k, marg.flags_device_cuda(*args)))
    assert flagged > 0


def test_marg_policy_wrapper_is_one_call(tracked, marg_windows):
    """K15p's wrapper: no torch operator but the outputs' allocations, and
    one kernel a call on the device."""
    tracker, _ = tracked
    cfg = tracker.config
    args = (marg_windows["filled"], tracker.immature.valid, cfg.window_min, cfg.window_max,
            cfg.max_marginalized_fraction)
    assert _aten_ops(marg.flags_device_cuda, *args) <= ALLOCATION_OPS
    marg.flags_device_cuda(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiled(acts) as prof:
        marg.flags_device_cuda(*args)
        torch.cuda.synchronize()
    kernels_run = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels_run) == 1 and "policy_kernel" in kernels_run[0], kernels_run


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_gather_kernel_matches_plain(dtype):
    """The row gather at the probe's shapes equal to ``table[idx]`` to the
    bit; an index outside the table: a zero row from the kernel, an error
    from the checked wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table, table_bf, idx = gather_probe.probe_inputs("cuda")
    tab = table if dtype == "f32" else table_bf
    before = kernels.ROW_GATHER.launches
    out_k = _no_host_reads(gather_probe.row_gather_cuda, tab, idx)
    assert kernels.ROW_GATHER.launches == before + 1
    assert torch.equal(out_k, gather_probe.row_gather_plain(tab, idx))
    bad = idx[:64].clone()
    bad[3], bad[9] = -1, tab.shape[0]
    out_bad = gather_probe.row_gather_cuda(tab, bad)
    assert not bool(out_bad[[3, 9]].any()) and torch.equal(out_bad[:3], tab[bad[:3]])
    with pytest.raises(IndexError):
        gather_probe.row_gather(tab, bad)


@pytest.mark.parametrize("size", [(480, 640), (479, 637)])
@pytest.mark.parametrize("raw_dtype", ["u8", "f32"])
@pytest.mark.parametrize("with_vignette", [False, True])
def test_photometric_kernel_matches_plain(size, raw_dtype, with_vignette):
    """K18 equal to its plain version to the bit: u8 and f32 frames (the f32
    ones reach past both ends of [0, 255]), with and without a vignette (some
    of it below the 1e-3 floor), at VGA and at a width that is not a multiple
    of 4; one launch per call, and an unaligned f32 view takes the scalar path
    to the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.testing import paths

    h, w = size
    gen = torch.Generator(device="cuda").manual_seed(h + w)
    lut = torch.as_tensor(paths.inverse_response(), device="cuda")
    if raw_dtype == "u8":
        raw = torch.randint(0, 256, (h, w), generator=gen, device="cuda", dtype=torch.uint8)
    else:
        raw = torch.rand((h, w), generator=gen, device="cuda") * 275.0 - 10.0
        raw[0, :6] = torch.tensor([0.0, 255.0, 254.5, -0.0, 254.99998, 17.0])
    vig = None
    if with_vignette:
        vig = torch.as_tensor(paths.sensor_vignette(h, w), device="cuda")
        vig[1, :5] = torch.tensor([0.0, 1e-4, 1e-3, -1.0, 2e-3])
    before = kernels.PHOTOMETRIC.launches
    out_k = _no_host_reads(ph.correct_image_cuda, raw, lut, vig)
    assert kernels.PHOTOMETRIC.launches == before + 1
    assert out_k.dtype == torch.float32 and tuple(out_k.shape) == (h, w)
    assert torch.equal(out_k, ph.correct_image_plain(raw, lut, vig))
    assert torch.equal(ph.correct_image(raw, lut, vig), out_k)
    if raw_dtype == "f32":
        flat = torch.empty(h * w + 1, device="cuda")
        shifted = flat[1:].view(h, w)      # 4 bytes past a 16-byte boundary
        shifted.copy_(raw)
        assert torch.equal(ph.correct_image_cuda(shifted, lut, vig), out_k)
    with pytest.raises(ValueError):
        ph.correct_image_cuda(raw.double() if raw_dtype == "f32" else raw.t(), lut, vig)


@pytest.mark.parametrize("dtype,cols,m", [
    ("f32", 12, 1), ("f32", 12, 31), ("bf16", 12, 1001), ("bf16", 12, 204801),
    ("f32", 2, 4097), ("f32", 4, 4097), ("f32", 64, 4097), ("bf16", 4, 4097),
    ("bf16", 12, 4097)])
def test_row_gather_ragged_and_row_widths(dtype, cols, m):
    """The row gather equal to ``table[idx]`` to the bit at a tile's ragged
    end (m of 1, 31, an odd count, 204801) and at rows of 8, 16, 24, 48 and
    256 bytes (the last a warp a row), an index outside the table giving a
    zero row; from an index view that starts 4 bytes past a 16-byte boundary
    too; a bf16 row of 4 bytes refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(cols * 7 + m)
    torch_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
    rows = 5000 if m < 204801 else gather_probe.HW
    table = torch.as_tensor(rng.standard_normal((rows, cols)).astype(np.float32),
                            device="cuda").to(torch_dtype)
    idx = torch.as_tensor(rng.integers(0, rows, m + 1).astype(np.int32), device="cuda")
    before = kernels.ROW_GATHER.launches
    for ids in (idx[:m], idx[1:]):
        out = _no_host_reads(gather_probe.row_gather_cuda, table, ids)
        assert out.dtype == torch_dtype and tuple(out.shape) == (m, cols)
        assert torch.equal(out, gather_probe.row_gather_plain(table, ids))
    assert kernels.ROW_GATHER.launches == before + 2
    bad = idx[:m].clone()
    bad[m // 2] = rows if m % 2 else -5
    out_bad = gather_probe.row_gather_cuda(table, bad)
    keep = torch.ones(m, dtype=torch.bool, device="cuda")
    keep[m // 2] = False
    assert not bool(out_bad[m // 2].any())
    assert torch.equal(out_bad[keep], table[bad[keep]])
    if dtype == "bf16":
        with pytest.raises(ValueError, match="multiple of 8"):
            gather_probe.row_gather_cuda(table[:, :2].contiguous(), idx[:m])


def _distorted_remaps(h, w):
    from dsopp_tpu_torch.core.camera import SimpleRadial
    from dsopp_tpu_torch.sensors.undistorter import build_remaps

    source = SimpleRadial.create((float(w), float(h)), 500.0, ((w - 1) / 2.0, (h - 1) / 2.0),
                                 -0.12, 0.02)
    return build_remaps(source, "cuda")


def _pinned(tensor):
    """``tensor`` in pinned host memory, and the event its intake records."""
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    out.copy_(tensor.cpu())
    copied = torch.cuda.Event()
    copied.record()
    return out, copied


@pytest.mark.parametrize("size", [(480, 640), (479, 637)])
@pytest.mark.parametrize("raw_dtype", ["u8", "f32"])
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("with_vignette", [False, True])
def test_photometric_intake_matches_plain_chain(size, raw_dtype, tables, with_vignette):
    """K18 as the camera's intake (the upload from a pinned buffer, the remap
    through SimpleRadial tables or none, the crop to a multiple of 16) equal
    to the bit to the plain chain on the CPU (``intake_plain``: the remap,
    the crop and the correction), one launch a call with no host read; and
    K18 on a crop's view of a frame on the card equal to the plain
    correction of that crop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.testing import paths

    h, w = size
    ch, cw = h // 16 * 16, w // 16 * 16
    gen = torch.Generator(device="cuda").manual_seed(h + w + 3)
    lut = torch.as_tensor(paths.inverse_response(), device="cuda")
    if raw_dtype == "u8":
        raw = torch.randint(0, 256, (h, w), generator=gen, device="cuda", dtype=torch.uint8)
    else:
        raw = torch.rand((h, w), generator=gen, device="cuda") * 275.0 - 10.0
    vig = torch.as_tensor(paths.sensor_vignette(ch, cw), device="cuda") if with_vignette else None
    maps = _distorted_remaps(h, w).maps32() if tables else None
    pinned, copied = _pinned(raw)
    before = kernels.PHOTOMETRIC.launches
    out = _no_host_reads(ph.intake_cuda, pinned, copied, lut, vig, maps, (ch, cw))
    assert kernels.PHOTOMETRIC.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (ch, cw)
    plain = ph.intake_plain(pinned, lut.cpu(), None if vig is None else vig.cpu(),
                            None if maps is None else tuple(m.cpu() for m in maps), (ch, cw))
    assert torch.equal(out.cpu(), plain)
    view = _no_host_reads(ph.correct_image_cuda, raw[:ch, :cw], lut, vig)
    assert torch.equal(view.cpu(), ph.correct_image_plain(raw.cpu()[:ch, :cw], lut.cpu(),
                                                          None if vig is None else vig.cpu()))
    if not tables:
        assert torch.equal(out, view)
    with pytest.raises(ValueError, match="pinned"):
        ph.intake_cuda(raw, copied, lut, vig, maps, (ch, cw))
    with pytest.raises(ValueError, match="copied"):
        ph.intake_cuda(pinned, None, lut, vig, maps, (ch, cw))


def _camera_folder(folder, h, w, frames, model="pinhole"):
    """A camera's files: ``frames`` raw u8 frames with class-id images, times,
    G⁻¹ and a calibration; → the camera's config section."""
    from dsopp_tpu_torch.testing import paths

    rng = np.random.default_rng(h + frames)
    (folder / "images").mkdir()
    (folder / "semantics").mkdir()
    for i in range(frames):
        np.save(folder / "images" / f"{i}.npy", rng.integers(0, 256, (h, w)).astype(np.uint8))
        np.save(folder / "semantics" / f"{i}.npy", paths.semantic_classes(h, w))
    (folder / "times.txt").write_text("".join(f"{i} {0.1 * i} 1.0\n" for i in range(frames)))
    (folder / "pcalib.txt").write_text(" ".join(repr(float(v)) for v in paths.inverse_response()))
    intr = {"pinhole": "150 150 79.5 59.5", "simple_radial": "150 79.5 59.5 -0.12 0.02"}[model]
    (folder / "calib.txt").write_text(f"{model}\n{w} {h}\n{intr}\n")
    return {"provider": {"type": "npy_folder", "folder": "images", "timestamps": "times.txt"},
            "model": {"calibration": "calib.txt", "photometric_calibration": "pcalib.txt"},
            "semantics": {"folder": "semantics", "filter": [paths.SEMANTIC_FILTERED]}}


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
def test_next_frame_makes_no_host_sync(tmp_path, model):
    """``Camera.next_frame`` on the card with every host synchronisation an
    error (the first frame too: G⁻¹ and the vignette go up from pinned
    memory), one K18 launch a frame, each frame equal to the plain chain of
    its raw file (a 136 x 100 frame cropped to 128 x 96); the class-id
    image's upload for the candidate mask (``MonocularTracker.semantic_mask``)
    with no host sync either, equal to the plain filter."""
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.sensors.camera import Camera
    from dsopp_tpu_torch.sensors.masks import filter_semantic_objects
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, frames = 100, 136, 4
    params = _camera_folder(tmp_path, h, w, frames, model)
    camera = Camera.from_config("camera_1", params, base_dir=str(tmp_path), device="cuda")
    camera.settings.vignetting = paths.sensor_vignette(96, 128)
    tracker = MonocularTracker(camera.camera_model(), TrackerConfig(), device="cuda")
    tracker.semantic_filter = (paths.SEMANTIC_FILTERED,)
    und = camera.settings.undistorter
    maps = None if und is None else tuple(m.cpu() for m in und.maps32())
    assert (maps is None) == (model == "pinhole")
    lut = torch.as_tensor(paths.inverse_response())
    vig = torch.as_tensor(paths.sensor_vignette(96, 128))
    for i in range(frames):
        before = kernels.PHOTOMETRIC.launches
        frame = _no_host_reads(camera.next_frame)
        assert kernels.PHOTOMETRIC.launches == before + 1
        assert frame.frame_id == i and frame.image.is_cuda
        raw = np.load(tmp_path / "images" / f"{i}.npy")
        assert torch.equal(frame.image.cpu(), ph.intake_plain(raw, lut, vig, maps, (96, 128)))
        mask = _no_host_reads(tracker.semantic_mask, frame.semantics)
        expected = filter_semantic_objects(torch.ones((96, 128), dtype=torch.bool),
                                           torch.as_tensor(frame.semantics), (7,))
        assert torch.equal(mask.cpu(), expected)
    assert camera.next_frame() is None
    assert camera.ring_waits == 0


def test_intake_ring_under_load(tmp_path):
    """The pinned ring while the card is busy: a long kernel queued first,
    then 4 frames pushed through ``next_frame`` (3 buffers): the fourth
    waits, by polling its buffer's event, for the first frame's copy, and
    every frame comes out equal to the plain chain of its file."""
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.sensors.camera import Camera
    from dsopp_tpu_torch.testing import paths

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, frames = 96, 128, 4
    params = _camera_folder(tmp_path, h, w, frames)
    camera = Camera.from_config("camera_1", params, base_dir=str(tmp_path), device="cuda")
    camera.next_frame()                  # the constants go up before the load
    camera.provider.pos = 0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))          # ~0.15 s of one block spinning
    outs = [camera.next_frame().image for _ in range(frames)]
    assert camera.ring_waits == 1
    lut = torch.as_tensor(paths.inverse_response())
    for i, out in enumerate(outs):
        raw = np.load(tmp_path / "images" / f"{i}.npy")
        assert torch.equal(out.cpu(), ph.intake_plain(raw, lut, None, None, (h, w)))


# ---------------------------------------------------------------------------
# C > 1 frame-embedder channels (the embedder path's window, C = 3, and its
# first two channels as a window of C = 2)

@pytest.fixture(scope="module")
def embedded():
    """``tracked``'s tracker with the filter-bank embedder (C = 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return align_trace.small_tracker("filter_bank")


def _first_channels(win, c):
    """``win`` (C channels) as a window of its first ``c`` channels."""
    cc, (k, n) = win.num_channels, win.lm_valid.shape
    planes = [g * cc + i for g in range(3) for i in range(c)]
    patch = win.lm_patch.reshape(k, n, cc, 8)[:, :, :c].reshape(k, n, 8 * c)
    return win.replace(channel_maps=win.channel_maps[:, planes].contiguous(),
                       lm_patch=patch.contiguous())


def test_channel_map_kernel_matches_plain(embedded):
    tracker, maps = embedded
    chans = tracker.embedder(maps[0][0].contiguous())
    before = kernels.PYRAMID.launches
    for c in (2, 3):
        out = pyramid.build_channel_map(chans[:c].contiguous())
        assert out.shape == (3 * c,) + tuple(chans.shape[1:])
        assert float((out - pyramid.build_pixel_map(chans[:c])).abs().max()) <= 1e-3
    assert kernels.PYRAMID.launches == before + 2


@pytest.mark.parametrize("channels", [2, 3])
def test_ba_evaluate_kernel_matches_plain_at_c(embedded, channels):
    tracker, _ = embedded
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    win = _first_channels(win, channels)
    args = (win, tracker.models[0], eps, idepth, lm_mask, tracker.pba_opts)
    ev_k = pba._evaluate_cuda(*args)
    ev_p = pba._evaluate_plain(*args)
    assert ev_k.residuals.shape == (win.num_slots, win.num_slots, win.num_landmark_slots,
                                    channels, 8)
    live = pba._pair_mask(win)[:, :, None] & lm_mask[:, None, :]
    err = parity.evaluation_errors(ev_k, ev_p, live)
    assert err["ok"] > 100 and err["agree"] >= 0.999, err
    assert max(err[name] for name in ("residuals", "gx", "gy", "energy_patch", "weight")) <= 1e-4, err


@pytest.mark.parametrize("marg_pass", [False, True])
@pytest.mark.parametrize("channels", [2, 3])
def test_ba_linearize_kernel_matches_plain_at_c(embedded, channels, marg_pass):
    tracker, _ = embedded
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    win = _first_channels(win, channels)
    model, opts = tracker.models[0], tracker.pba_opts
    ev = pba._evaluate_plain(win, model, eps, idepth, lm_mask, opts)
    sys_k = pba._linearize_from_ev_cuda(win, model, ev, eps, opts, marg_pass)
    sys_p = pba._linearize_from_ev_plain(win, pba._fej_cache_plain(win, model), ev, eps, opts,
                                         marg_pass)
    err = parity.linear_system_errors(sys_k, sys_p)
    assert float(sys_p.h_schur.abs().max()) > 0
    assert max(err.values()) <= 1e-4, err
    again = pba._linearize_from_ev_cuda(win, model, ev, eps, opts, marg_pass)
    assert all(torch.equal(a, b) for a, b in zip(sys_k, again))     # two runs, the same bits


@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_ba_lm_loop_and_status_at_c3(embedded, ledger):
    tracker, _ = embedded
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    sys = pba._linearize_from_ev(win, model, pba._evaluate(win, model, eps, idepth, lm_mask, opts),
                                 eps, opts)
    if ledger == "filled":
        win = parity.scaled_ledger(win, sys)
    else:
        win = win.replace(h_marg=torch.zeros_like(win.h_marg),
                          b_marg=torch.zeros_like(win.b_marg),
                          energy_marg=torch.zeros_like(win.energy_marg))
    log_k, log_p = [], []
    res_k = pba._solve_loop_cuda(win, model, opts, log=log_k)
    res_p = pba._solve_loop_plain(win, model, opts, log=log_p)
    err = parity.solve_loop_errors(res_k, res_p, log_k, log_p)
    assert err["same_flags"], (log_k, log_p)
    assert (err["relins"] > 0) == (ledger == "empty")
    assert err["energy"] <= 1e-4 and err["rotation"] <= 1e-4 and err["translation"] <= 1e-4, err
    assert err["status_agree"] >= 0.999, err
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    ps_k = pba._point_status_from_ev_cuda(win, ev, lm_mask, opts)
    ps_p = pba._point_status_from_ev_plain(win, ev, lm_mask, opts)
    err = parity.point_status_errors(ps_k, ps_p, ev)
    assert err["status_differ"] == err["inliers_differ"] == err["flags_differ"] == 0, err


@pytest.mark.parametrize("channels", [2, 3])
def test_scatter_kernel_matches_plain_at_c(embedded, channels):
    """K14's pairing samples each moved point's C-channel patch from its host
    slot's bank: equal to the plain version entry by entry."""
    tracker, _ = embedded
    seq = render_sequence(num_frames=8, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    win, imm, _ = parity.keyframe_case(tracker, seq.images[6], seq.pose(6, torch.float32, "cuda"),
                                       6)
    win = _first_channels(win, channels)
    model = tracker.models[0]
    activate, delete, _ = act._activation_plain(win, model, imm, 1.5)
    idepth, keep, selected = act._refine_idepth_plain(win, model, imm, activate, 20.0)
    for args in ((win, imm, keep, delete, idepth, selected), (win, imm, activate, delete)):
        res_k = _no_host_reads(act._activation_scatter_cuda, *args)
        res_p = act._activation_scatter_plain(*args)
        assert res_k[0].lm_patch.shape[-1] == 8 * channels
        err = parity.scatter_errors(res_k, res_p)
        assert err.pop("n_activated") > 0
        assert not any(err.values()), err
        assert torch.equal(res_k[1].idepth_min, res_p[1].idepth_min)


@pytest.mark.parametrize("channels", [2, 3])
def test_align_kernels_match_plain_at_c(embedded, channels):
    """K2 and K3 against a map of C embedded channels, intensities [N, C]."""
    tracker, maps = embedded
    emb = tracker.embedder
    newest = int(tracker.window.frame_valid.sum()) - 1      # the frontend points' keyframe
    ref_map = pyramid.build_channel_map(emb(tracker.window.maps[newest][0].contiguous())
                                        [:channels].contiguous())
    tgt_map = pyramid.build_channel_map(emb(maps[0][0].contiguous())[:channels].contiguous())
    lp = tracker.level_points[0]
    from dsopp_tpu_torch.core.interpolate import sample
    vals, _ = sample(ref_map[:channels], lp.uv)
    pts = pa.LevelPoints(lp.uv, lp.idepth, vals.contiguous(), lp.valid)
    _, args = next(align_trace.level_cases(tracker, maps, [(0, 5)]))
    hyps, aff, aff_ref, ratio = args[3:7]
    opts = tracker.align_opts
    k2 = (pts, tgt_map, tracker.models[0], hyps, aff, aff_ref, ratio,
          pa.huber_sigma(tgt_map, opts))
    hk, bk, ek, nk = pa.residual_system_cuda(*k2)
    hp, bp, ep, np_ = pa.residual_system_plain(*k2)
    assert torch.equal(nk, np_) and int(nk.max()) > 100
    assert float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2))).max()) <= 1e-4
    assert float(((ek - ep).abs() / ep.abs()).max()) <= 1e-5
    k3 = (pts, tgt_map, tracker.models[0], hyps, aff, aff_ref, ratio, opts)
    res_k, res_p = pa.align_level_cuda(*k3), pa.align_level_plain(*k3)
    err = parity.align_level_errors(res_k, res_p)
    assert err["num_valid"] <= 5e-3 and err["energy"] <= 1e-3, err
    assert float(err["rotation"].max()) <= 1e-4 and float(err["translation"].max()) <= 1e-4, err
    assert parity.align_level_equal(res_k, pa.align_level_cuda(*k3))


@pytest.mark.parametrize("masked", [False, True])
def test_candidates_kernel_all_ties_at_vga(masked):
    """A VGA map of constant gradient: every allowed pixel scores the same,
    so the rank (a warp a tile over 1764 tiles) orders by tile index alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.testing.paths import path_mask
    h, w = 480, 640
    maps = torch.stack([torch.rand((h, w), device="cuda") * 255,
                        torch.full((h, w), 0.6, device="cuda"),
                        torch.full((h, w), -0.5, device="cuda")])
    mask = path_mask("masked") if masked else None
    for num_points in (800, 1200):
        out_k = _no_host_reads(extractor.select_candidates_cuda, maps, num_points, mask)
        out_p = extractor.select_candidates_plain(maps, num_points, mask)
        err = parity.candidates_errors(out_k, out_p)
        assert err["valid"] > 500 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
        assert err["grad2"] == 0.0, err


@pytest.mark.parametrize("case", ["c1", "k4", "solve", "frame", "marg", "kf"])
def test_outputs_match_the_parent(case):
    """Each case of ``testing/bits.py`` equal, digest by digest, to the tree
    before its redesign (no pose tie either): ``c1`` the C = 1 outputs of K1,
    K3, K7, K8, K10 and K11 (the tree before the channel axis); ``k4`` K4's
    on the BA parity windows' banks (the chain it replaced: the relative
    poses and the geometry in torch, the sweep kernel, the update in torch);
    ``solve`` the whole solve on the standart, dense and embedder windows,
    each with an empty and a filled ledger (the loop launched from Python);
    ``frame`` K5 with the decision and K14's pairing with the refinement's
    glue (the flows kernel and the torch decision; the torch glue, the
    clones and the pairing kernel); ``marg`` the marginalization on the
    solve case's windows in every flagging case (K15 after the priors and
    subtractions in torch, its rounds behind barriers of 1024 threads);
    ``kf`` K12 and K16 on a keyframe's window (K16's poses and mask composed
    in torch around the call; K12's rank a thread a tile), where an entry of
    K16's may instead equal the parent's K16 on this tree's composed poses
    (a named pose tie)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.testing import bits
    equal, ties, differ = bits.check(case, bits.run(case))
    assert equal and not differ, differ
    assert not ties or case == "kf", ties
    assert all("/k16" in key for key in ties), ties


def test_epipolar_kernel_is_deterministic_and_one_call(scene):
    """Two runs equal to the bit; the wrapper runs allocations only on the
    host and one launch, and reads nothing on the host (chip_smoke counts
    its device kernels under the profiler)."""
    args = _epipolar_case(scene)
    a = de.estimate_depths_cuda(*args)
    before = kernels.EPIPOLAR.launches
    b = _no_host_reads(de.estimate_depths_cuda, *args)
    assert kernels.EPIPOLAR.launches == before + 1
    for name in parity.EPIPOLAR_OUTPUTS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert _aten_ops(de.estimate_depths_cuda, *args) <= ALLOCATION_OPS


# The tests below open CUDA profiler sessions of many calls.  They come after
# test_marg_policy_wrapper_is_one_call, whose session of one call is the
# process's first: after such sessions a later one-launch session held no
# device record on the card (the K4 test above moved last for the same
# reason).


def test_flow_decision_wrapper_is_one_kernel(tracked):
    """K5 with the decision: one C call a call, and under the profiler no
    torch operator but the output's allocation on the host and the kernel
    alone on the device (of 20 calls' records, the ones the profiler keeps,
    which can lack a session's first)."""
    tracker, _ = tracked
    t_t_kf = SE3(tracker.t_w_last.q, tracker.t_w_last.t).inverse() @ tracker._kf_pose()
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    args = _statistics_args(tracker, t_t_kf, 1.0, 1.0, 0.5, 50, 1.25, False)
    dm.frame_statistics_cuda(*args)
    torch.cuda.synchronize()
    before = kernels.FLOW.launches
    with profiled([torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            dm.frame_statistics_cuda(*args)
        torch.cuda.synchronize()
    assert kernels.FLOW.launches == before + 20
    assert {e.name for e in prof.events() if e.name.startswith("aten::")} <= ALLOCATION_OPS
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(device) <= 20 and all("flow_kernel" in name for name in device), device


def test_pairing_wrapper_is_one_kernel_without_copies(keyframe):
    """The pairing with the refinement's glue inside: one C call a call, and
    under the profiler no torch operator but allocations on the host and the
    kernel alone on the device (no copy, no memset: of 20 calls' records, the
    ones the profiler keeps, which can lack a session's first); two runs
    equal to the bit."""
    tracker, win, imm, _ = keyframe
    model = tracker.models[0]
    activate, delete, _ = act._activation_plain(win, model, imm, 1.5)
    idepth, keep, selected = act._refine_idepth_plain(win, model, imm, activate, 20.0)
    args = (win, imm, keep, delete, idepth, selected)
    first = act._activation_scatter_cuda(*args)
    torch.cuda.synchronize()
    before = kernels.ACTIVATION_SCATTER.launches
    with profiled([torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            again = act._activation_scatter_cuda(*args)
        torch.cuda.synchronize()
    assert kernels.ACTIVATION_SCATTER.launches == before + 20
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(device) <= 20 and all("pair_slots_kernel" in name for name in device), device
    assert {e.name for e in prof.events() if e.name.startswith("aten::")} <= ALLOCATION_OPS
    tensors = lambda res: [*(getattr(res[0], f) for f in ("lm_uv", "lm_patch", "lm_idepth",  # noqa: E731
                                                        "lm_valid", "res_status")),
                           res[1].valid, res[1].idepth_min, res[1].idepth_max, res[2]]
    assert all(torch.equal(a, b) for a, b in zip(tensors(first), tensors(again)))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_frontend_state_wrapper_is_one_call(request, window):
    """K16: one C call a call, with no host read; under the profiler no
    torch operator but its two allocations and their views on the host, and
    only depth_maps.cu's kernels on the device (at most 10 a call, of 20
    calls' records); two runs equal to the bit; the poses it composed
    within ``parity.KERNEL_POSE_ULPS`` of torch's ``_older_landmarks``."""
    tracker, maps = request.getfixturevalue(WINDOWS[window])
    win, cfg = tracker.window, tracker.config
    h, w = tracker.image_shape
    args = (win, tracker.models[0], tuple(maps), h, w, cfg.pyramid_levels, cfg.frontend_points)
    rel_pose = torch.empty((win.num_slots, dm.POSE_WIDTH), device="cuda")
    first = _no_host_reads(dm.build_frontend_state_cuda, *args, poses_out=rel_pose)
    err = parity.frontend_pose_errors(win, rel_pose)
    assert err["pose_ulps"] <= parity.KERNEL_POSE_ULPS, err
    torch.cuda.synchronize()
    before = kernels.DEPTH_MAPS.launches
    with profiled([torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            again = dm.build_frontend_state_cuda(*args)
        torch.cuda.synchronize()
    assert kernels.DEPTH_MAPS.launches == before + 20
    ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
    assert ops <= ALLOCATION_OPS | set(parity.VIEW_OPS), ops
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(device) <= 20 * 10, len(device)
    assert all(any(k in name for k in parity.DEPTH_MAPS_KERNELS) for name in device), device
    assert all(torch.equal(x, y) for x, y in zip(_frontend_tensors(first),
                                                 _frontend_tensors(again)))


def test_flow_and_pairing_on_two_streams(tracked, keyframe):
    """K5 with the decision and the pairing launched on two side streams in
    turn, with no wait between them: each stream has its own workspace (the
    blocks' partials, the slots' takes, the tickets), and every launch's
    outputs equal the default stream's to the bit."""
    tracker, _ = tracked
    t_t_kf = SE3(tracker.t_w_last.q, tracker.t_w_last.t).inverse() @ tracker._kf_pose()
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    args = _statistics_args(tracker, t_t_kf, 1.0, 1.0, 0.5, 50, 1.25, False)
    _, win, imm, _ = keyframe
    model = tracker.models[0]
    activate, delete, _ = act._activation_plain(win, model, imm, 1.5)
    idepth, keep, selected = act._refine_idepth_plain(win, model, imm, activate, 20.0)
    pair_args = (win, imm, keep, delete, idepth, selected)

    def outputs(res):
        return [*(getattr(res[0], f) for f in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid",
                                               "res_status")),
                res[1].valid, res[1].idepth_min, res[1].idepth_max, res[2]]

    want_stats = dm.frame_statistics_cuda(*args)
    want_pair = outputs(act._activation_scatter_cuda(*pair_args))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    runs = []
    for _ in range(10):
        for stream in streams:
            with torch.cuda.stream(stream):
                runs.append((dm.frame_statistics_cuda(*args),
                             outputs(act._activation_scatter_cuda(*pair_args))))
    torch.cuda.synchronize()
    for kernel in (kernels.FLOW, kernels.ACTIVATION_SCATTER):
        owners = {key[2] for key in kernels._workspaces if key[0] == kernel.name}
        assert {stream.cuda_stream for stream in streams} <= owners, kernel.name
    for stats, pair in runs:
        assert torch.equal(stats, want_stats)
        assert all(torch.equal(a, b) for a, b in zip(pair, want_pair))


def test_marg_fold_forms_the_system_and_reads_nothing(tracked, marg_windows):
    """K15 from K8's raw system: no host read, no torch operator but its
    allocations (no ``diag`` of the priors, no subtraction), and three
    device kernels a call."""
    tracker, _ = tracked
    opts, model = tracker.pba_opts, tracker.models[0]
    start = marg_windows["filled"]
    slots = parity.marg_cases(start)["one free frame"]
    w, perm = parity.marg_case(start, "one free frame", slots,
                               torch.Generator(device="cuda").manual_seed(1))
    raw = _marg_raw(w, model, perm, opts)
    _no_host_reads(pba._marginalize_cuda, *raw)
    assert _aten_ops(pba._marginalize_cuda, *raw) <= ALLOCATION_OPS
    torch.cuda.synchronize()
    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pba._marginalize_cuda(*raw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(names) <= 15 and all("_kernel" in name for name in names), names


def test_status_and_fold_on_two_streams(tracked, marg_windows):
    """K11 (its workspace: histograms, ticket, selection) and K15 launched on
    two side streams in turn, with no wait between them: each stream has its
    own K11 workspace, and every launch's outputs equal the default stream's
    to the bit, as do two runs on one stream."""
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    start = marg_windows["filled"]
    slots = parity.marg_cases(start)["two frames"]
    w, perm = parity.marg_case(start, "two frames", slots,
                               torch.Generator(device="cuda").manual_seed(1))
    raw = _marg_raw(w, model, perm, opts)

    def outputs():
        return [*pba._point_status_from_ev_cuda(win, ev, lm_mask, opts),
                *pba._marginalize_cuda(*raw)]

    want = outputs()
    assert all(torch.equal(a, b) for a, b in zip(outputs(), want))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    runs = []
    for _ in range(10):
        for stream in streams:
            with torch.cuda.stream(stream):
                runs.append(outputs())
    torch.cuda.synchronize()
    owners = {key[2] for key in kernels._workspaces if key[0] == kernels.BA_STATUS.name}
    assert {stream.cuda_stream for stream in streams} <= owners
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(run, want))


def test_good_features_on_card_equal_plain(scene):
    """``fbs/klt.py``'s corners on the card (the response, its maxima and
    their order there, the spacing pass on the host) equal the plain
    version's, order included, on three corridor frames."""
    from dsopp_tpu_torch.fbs import klt

    for i in range(3):
        img = scene.images[i]
        card = klt.good_features(img)
        plain = klt.good_features_plain(img.cpu().numpy())
        assert len(plain) > 300
        np.testing.assert_array_equal(card, plain)
        assert torch.equal(klt.min_eigenvalues(klt.as_u8(img)).cpu(),
                           torch.as_tensor(klt.min_eigenvalues_plain(klt.as_u8(
                               img.cpu().numpy()))))


def test_pyr_lk_on_card_within_plain(scene):
    """``pyr_lk`` on the card against its plain version (the corners of frame
    0 and 200 points over and around the image, tracked into frames 1 and
    3): the status equal, positions within 1e-3 px; no host read inside."""
    from dsopp_tpu_torch.fbs import klt

    h, w = scene.images.shape[1:]
    prev = scene.images[0].cpu().numpy()
    rng = np.random.default_rng(3)
    pts = np.concatenate([klt.good_features_plain(prev),
                          rng.uniform([-30, -30], [w + 30, h + 30], (200, 2))]).astype(np.float32)
    points = torch.as_tensor(pts, device="cuda")
    for j in (1, 3):
        u8 = [klt.as_u8(scene.images[i]) for i in (0, j)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, status = klt.pyr_lk(*u8, points)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        plain, plain_status = klt.pyr_lk_plain(prev, scene.images[j].cpu().numpy(), pts)
        assert np.array_equal(status.cpu().numpy(), plain_status)
        assert plain_status.sum() > 300
        err = np.abs(out.cpu().numpy() - plain)[plain_status].max()
        assert err <= 1e-3, err


def test_so3xs2_refine_on_card_syncs_outside_its_loop():
    """The SO3×S2 refinement of the bootstrap on the card (f64, the two-view
    scene of ``tests/fbs/test_initializer.py`` with noise) equals the CPU's
    within 1e-9, and 40 iterations sync the host at the lines, and as often,
    as 1 does: its inputs' uploads and its results' reads, none in the loop."""
    import collections
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.fbs.geometric_ba import _so3_exp
    from dsopp_tpu_torch.fbs.geometry import so3xs2_refine

    rng = np.random.default_rng(3)
    pts = rng.uniform([-2, -2, 3], [2, 2, 8], (150, 3))
    r_gt = _so3_exp(np.array([0.05, -0.1, 0.02]))
    t_gt = np.array([0.5, 0.1, -0.05]) / np.linalg.norm([0.5, 0.1, -0.05])
    cam2 = pts @ r_gt.T + t_gt
    m1 = pts[:, :2] / pts[:, 2:3] + rng.normal(0, 5e-4, (150, 2))
    m2 = cam2[:, :2] / cam2[:, 2:3] + rng.normal(0, 5e-4, (150, 2))
    args = (m1 * 400.0, m2 * 400.0, _so3_exp(np.array([0.01, -0.008, 0.012])) @ r_gt,
            t_gt + np.array([0.05, -0.04, 0.03]), 300.0, 2.0)

    def sites(iterations):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = so3xs2_refine(*args, optimize_focal=True, iterations=iterations,
                                    device="cuda")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                        if "synchroniz" in str(w.message))

    sites(1)                                   # the solver's handles made
    _, once = sites(1)
    card, looped = sites(40)
    assert looped == once and sum(once.values()) > 0, (looped, once)
    cpu = so3xs2_refine(*args, optimize_focal=True, iterations=40, device="cpu")
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert abs(card[2] - 400.0) < 100.0


def test_app_tracked_phase_adds_no_host_sync(tmp_path):
    """A short app run on the card (240×320, 30 ``.npy`` frames, the
    precalculated-poses route) with sync debug "warn": its tracked phase, from
    the first ``PipelinedTracker`` tick through the last frames'
    bookkeeping, syncs no more a frame, and at no other line, than the same
    frames driven straight through ``PipelinedTracker`` from the same
    bootstrap, the standart path's loop."""
    import collections
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.config import loader
    from dsopp_tpu_torch.output.tum import export_tum
    from dsopp_tpu_torch.sensors.camera import Camera
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    seq = render_sequence(num_frames=30, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    config = paths.app_config(desired_points=1200, window=(3, 5), factor=3.0)
    config["initializer"] = {"type": "precalculated", "poses_file": "gt.tum",
                             "num_frames": paths.INIT_FRAMES}
    path = paths.write_app_folder(seq, str(tmp_path), config)
    export_tum(str(tmp_path / "gt.tum"),
               [(float(seq.timestamps[i]), seq.pose(i).matrix().double().cpu().numpy())
                for i in range(30)])

    def sites(records):
        return collections.Counter(f"{r.filename}:{r.lineno}" for r in records
                                   if "synchroniz" in str(r.message))

    # first the same frames from the same bootstrap straight through
    # PipelinedTracker (it pays the process's one read of the re-track's
    # perturbation table)
    ref = loader.build_application(loader.load_config(path), str(tmp_path))
    ref.run(max_frames=paths.INIT_FRAMES)
    assert ref.tracker.is_initialized()
    # run() read one frame past its last: a fresh camera from the first tracked frame
    camera = Camera.from_config("camera_1", config["sensors"][0], str(tmp_path))
    for _ in range(paths.INIT_FRAMES):
        camera.next_frame()
    pipe = PipelinedTracker(ref.tracker, flush_every=16)
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while (frame := camera.next_frame()) is not None:
                pipe.tick(frame.frame_id, frame.timestamp, frame.image, exposure=frame.exposure)
            pipe.drain()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref_sites = sites(syncs)
    # then the app: count from the first tracked tick to the end of the run
    app = loader.build_application(loader.load_config(path), str(tmp_path))
    tick, mark = PipelinedTracker.tick, {}
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")

        def first_tick(self, frame_id, *args, **kwargs):
            mark.setdefault("first", (len(syncs), frame_id))
            return tick(self, frame_id, *args, **kwargs)

        PipelinedTracker.tick = first_tick
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n = app.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            PipelinedTracker.tick = tick
        app_sites = sites(syncs[mark["first"][0]:])
    assert n == 30 and mark["first"][1] == paths.INIT_FRAMES

    # the app's count also holds finalize's three reads of the state
    # written back into the tracker
    finalize = {k: v for k, v in app_sites.items() if k not in ref_sites}
    assert sum(finalize.values()) <= 3 and all("device_loop.py" in k for k in finalize), finalize
    assert sum(app_sites.values()) - sum(finalize.values()) <= sum(ref_sites.values()), (
        app_sites, ref_sites)
    assert app.tracker.num_keyframes == pipe.num_keyframes


def test_pose_covariances_on_the_card_match_plain(tracked):
    """``pose_covariances``: K7 and K8 once each, cov and cov_rel within
    ``parity.POSE_COV_F32_TOL`` of the largest live entry of the plain
    version's in f32 on the same window."""
    tracker, _ = tracked
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    before = kernels.counts()
    out = pba.pose_covariances(win, model, opts)
    after = kernels.counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == {"ba_evaluate": 1, "ba_linearize_schur": 1}, launched
    ref = pba.pose_covariances(parity.moved(win, "cpu"), model, opts)
    errs = parity.covariance_errors(out, ref, win.frame_valid)
    assert max(errs.values()) <= parity.POSE_COV_F32_TOL, errs


def test_solve_window_and_marginalize_read_nothing_on_the_host(tracked):
    """``solve_window`` without its readback and ``marginalize`` with its flags
    given, with every host synchronisation an error: the same bits as the
    one-call solve and the fold with the kept-first permutation; nothing
    flagged gives the window back."""
    tracker, _ = tracked
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    solved, (energy, count) = _no_host_reads(pba.solve_window, win, model, opts,
                                             readback=False)
    ref, e_ref, n_ref = pba._solve_loop_cuda(win, model, opts)
    assert torch.equal(solved.eps, ref.eps) and torch.equal(solved.lm_idepth, ref.lm_idepth)
    assert torch.equal(energy, e_ref) and int(count) == int(n_ref) > 0
    frames = torch.zeros_like(win.frame_valid)
    frames[1] = True
    frames &= win.frame_valid
    gen = torch.Generator(device="cuda").manual_seed(3)
    flagged = win.replace(frame_marg=frames, lm_marg_flag=win.lm_valid & (
        torch.rand(win.lm_valid.shape, generator=gen, device="cuda") < 0.2))
    out = _no_host_reads(pba.marginalize, flagged, model, opts,
                         frame_flags=frames.cpu().numpy(), lm_any=True)
    perm = marg.kept_first_perm(flagged.frame_valid, flagged.frame_marg & flagged.frame_valid)
    ref = pba._marginalize_device(flagged, model, perm, opts)
    for name in ("h_marg", "b_marg", "energy_marg", "frame_valid", "frame_id", "lm_valid"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert int(out.frame_valid.sum()) == int(win.frame_valid.sum()) - 1
    k = win.num_slots
    assert pba.marginalize(win, model, opts, frame_flags=np.zeros(k, bool), lm_any=False) is win


def test_checkpoint_resume_on_the_card(tmp_path):
    """A run at 240×320 tracked straight and a run saved after frame 20,
    loaded and resumed on the card: every resumed position within 1e-6 m of
    the straight run's, and every kernel of the tracked path launched after
    the resume."""
    from dsopp_tpu_torch.output.checkpoint import load_checkpoint, save_checkpoint
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
    from dsopp_tpu_torch.tracker.monocular import TrackerConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seq = render_sequence(num_frames=40, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    cfg = TrackerConfig(num_frame_slots=6, landmarks_per_frame=120, immature_per_frame=300,
                        desired_points=600, frontend_points=800, keyframe_factor=3.0,
                        window_min=2, window_max=4)

    def run(tracker, frames):
        pipe = PipelinedTracker(tracker, flush_every=16)
        poses = [pipe.tick(i, float(seq.timestamps[i]), seq.images[i]).pose_t
                 for i in frames]
        pipe.finalize()
        return poses

    straight = paths.bootstrap(seq, cfg)
    poses_a = run(straight, range(paths.INIT_FRAMES, 40))
    stopped = paths.bootstrap(seq, cfg)
    poses_b = run(stopped, range(paths.INIT_FRAMES, 20))
    save_checkpoint(str(tmp_path / "state.npz"), stopped)
    resumed = load_checkpoint(str(tmp_path / "state.npz"), seq.camera, cfg)
    kernels.reset_counts()
    poses_b += run(resumed, range(20, 40))
    counts = kernels.counts()
    gap = float((torch.stack(poses_a) - torch.stack(poses_b)).norm(dim=-1).max())
    assert gap <= 1e-6, gap
    assert resumed.num_keyframes == straight.num_keyframes > stopped.num_keyframes
    path = ("pyramid_maps", "align_level", "epipolar_update", "flow_statistic", "ba_evaluate",
            "ba_linearize_schur", "ba_solve_step", "ba_lm", "ba_point_status",
            "select_candidates", "activation", "refine_idepth", "activation_scatter",
            "depth_maps", "marg_policy", "marg_fold")
    assert all(counts[name] > 0 for name in path), counts


# the batched tick (tracker/batched_loop.py): K1, K3, K4 and K5 over B = 4
# sequences in one call, each sequence equal to its own launch to the bit
BATCH_CASES = ("pyramid_maps", "align_level chunk 0", "align_level level 0",
               "align_level re-track", "epipolar_update", "flow_statistic")
BATCH_KERNEL = {"pyramid_maps": "PYRAMID", "epipolar_update": "EPIPOLAR",
                "flow_statistic": "FLOW"}


@pytest.fixture(scope="module")
def batch4():
    """Four trackers bootstrapped on offset copies of a 240×320 corridor
    (frames k..k+5), at the standart point's window and the re-track armed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.testing import batched, paths
    from dsopp_tpu_torch.tracker.monocular import TrackerConfig

    seq = render_sequence(num_frames=30, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    cfg = TrackerConfig(num_frame_slots=6, landmarks_per_frame=120, immature_per_frame=300,
                        desired_points=600, frontend_points=800, keyframe_factor=3.0,
                        window_min=2, window_max=4, use_rotation_perturbations=True)
    trackers = [batched.offset_bootstrap(seq, cfg, k) for k in range(4)]
    images = torch.stack([seq.images[k + paths.INIT_FRAMES] for k in range(4)]).contiguous()
    return seq, cfg, trackers, images


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("case", BATCH_CASES)
def test_batched_kernels_equal_solo_launches(batch4, case, batch):
    """One launch of the kernel for the B sequences (K3: one for all the
    case's sequences), each sequence's outputs equal to the bit to its own
    launch on the same inputs, with no host read; at B = 1, 2 and 4."""
    from dsopp_tpu_torch.testing import batched

    _, _, trackers, images = batch4
    fn, solos, _, rows_per = batched.kernel_cases(trackers[:batch],
                                                  images[:batch].contiguous())[case]
    kernel = getattr(kernels, BATCH_KERNEL.get(case, "ALIGN_LEVEL"))
    before = kernel.launches
    out = _no_host_reads(fn)
    assert kernel.launches == before + 1
    assert batched.case_equal(case, out, [f() for f in solos], rows_per)
    assert batched.case_equal(case, fn(), [f() for f in solos], rows_per)


def test_batched_tick_equals_solo_ticks_and_launches_do_not_grow(batch4):
    """One batched tick of the four sequences equals each sequence's
    ``device_tick`` to the bit (else the first stage that parts is named),
    and the regular tick launches the same kernels at B = 4 as at B = 1."""
    from dsopp_tpu_torch.testing import batched
    from dsopp_tpu_torch.tracker import batched_loop as bl
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, device_tick

    _, cfg, trackers, images = batch4
    pipes = [PipelinedTracker(t) for t in trackers]
    states = [p.state for p in pipes]
    models, loop = pipes[0].models, pipes[0].cfg
    assert batched.stage_diff(states, images, models, loop) == "none"
    counted = {}

    def regular(b):
        args = batched.regular_tick_args(states[:b], images[:b].contiguous(), models, loop)
        bl.fused_regular_tick(*args)       # the constants' one-time uploads
        torch.cuda.synchronize()
        # a profiler session can lose device records, not the host's launch
        # calls: those are counted, the most of three sessions
        calls = []
        for _ in range(3):
            kernels.reset_counts()
            with profiled([torch.profiler.ProfilerActivity.CPU,
                           torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = bl.fused_regular_tick(*args)
                torch.cuda.synchronize()
            calls.append(launch_records(prof)["host"])
        # (torch picks each elementwise kernel's variant by its sizes: the
        # count is held, not the names)
        return {k: v for k, v in kernels.counts().items() if v}, max(calls), any(out.escalated)
    for b in (1, 4):
        counted[b] = regular(b)
    if counted[1][2] == counted[4][2]:      # the same escalation outcome
        assert counted[1][:2] == counted[4][:2], counted
    new, diag = bl.batched_device_tick(bl.stack_states(states), images, [6] * 4, [False] * 4,
                                       models, pipes[0].mask, loop)
    for b in range(4):
        state, sdiag = device_tick(states[b], images[b], 6, False, models, loop)
        assert torch.equal(diag.pose_t[b], sdiag.pose_t)
        assert diag.is_keyframe[b] == sdiag.is_keyframe


@pytest.fixture(scope="module")
def solver_starts(dense_tracked):
    """Four starts of the dense window moved off its state (two draws, each
    with an empty and a filled ledger), stacked, with a mask of valid
    immature points and the policy's sizes (the window one frame too large)."""
    from dsopp_tpu_torch.testing import batched

    tracker, _ = dense_tracked
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    windows = batched.solver_starts(win, model, opts)
    frames = int(win.frame_valid.sum())
    cfg = tracker.config
    sizes = (min(cfg.window_min, frames - 2), frames - 1, cfg.max_marginalized_fraction)
    return windows, batched.immature_valid(windows, cfg.immature_per_frame), sizes, model, opts


SOLVER_SEQS = {1: (2,), 2: (3, 1), 4: (1, 3, 0, 2)}


@pytest.mark.parametrize("size", [1, 2, 4])
def test_batched_solver_half_equals_solo_calls(solver_starts, size):
    """The solve, the policy, the pass and the fold of S sequences, one
    call each, equal to the bit to S solo calls step by step, the LM logs
    too; with no host read."""
    from dsopp_tpu_torch.testing import batched

    windows, imm, sizes, model, opts = solver_starts
    seqs = SOLVER_SEQS[size]
    half = _no_host_reads(batched.solver_half, windows, imm, seqs, model, opts, sizes)
    logs, solo_logs = [], [[] for _ in seqs]
    again = batched.solver_half(windows, imm, seqs, model, opts, sizes, log=logs)
    solos = [batched.solver_half_solo(windows, imm, b, model, opts, sizes, log=log)
             for b, log in zip(seqs, solo_logs)]
    assert batched.solver_half_equal(half, solos) == dict.fromkeys(batched.SOLVER_STEPS, True)
    assert batched.solver_half_equal(again, solos) == dict.fromkeys(batched.SOLVER_STEPS, True)
    assert logs == solo_logs
    assert int(half["policy"][0].sum()) > 0


@pytest.mark.parametrize("size", [1, 2, 4])
def test_batched_solver_half_launches_equal_a_solo_half(solver_starts, size):
    """The half's hand-written launches at S sequences are one solo half's:
    the wrappers' counts and the host's launch calls outside torch
    operators."""
    from dsopp_tpu_torch.testing import batched

    windows, imm, sizes, model, opts = solver_starts
    seqs = SOLVER_SEQS[size]

    def launched(fn):
        fn()
        torch.cuda.synchronize()
        before = kernels.counts()
        with profiled([torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return ({k: v - before[k] for k, v in kernels.counts().items() if v != before[k]},
                launch_records(prof)["outside_ops"])

    got = launched(lambda: batched.solver_half(windows, imm, seqs, model, opts, sizes))
    want = launched(lambda: batched.solver_half_solo(windows, imm, seqs[0], model, opts, sizes))
    assert got == want
    assert got[0]["ba_solve_loop"] == 1 and got[0]["marg_fold"] == 1


def test_batched_solver_half_at_c3(embedded):
    """The solver half of two of four starts of the embedder's window (C =
    3 channels: K7's and K8's channel planes read through the stacked channel
    bank's per-sequence stride) equal to the bit to the solo calls, the LM
    logs too."""
    from dsopp_tpu_torch.testing import batched

    tracker, _ = embedded
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    assert win.num_channels == 3
    windows = batched.solver_starts(win, model, opts)
    imm = batched.immature_valid(windows, tracker.config.immature_per_frame)
    frames = int(win.frame_valid.sum())
    sizes = (min(tracker.config.window_min, frames - 2), frames - 1,
             tracker.config.max_marginalized_fraction)
    seqs = (3, 0)
    logs, solo_logs = [], [[] for _ in seqs]
    half = _no_host_reads(batched.solver_half, windows, imm, seqs, model, opts, sizes)
    batched.solver_half(windows, imm, seqs, model, opts, sizes, log=logs)
    solos = [batched.solver_half_solo(windows, imm, b, model, opts, sizes, log=log)
             for b, log in zip(seqs, solo_logs)]
    assert batched.solver_half_equal(half, solos) == dict.fromkeys(batched.SOLVER_STEPS, True)
    assert logs == solo_logs


def test_batched_solve_and_marginalize_equals_the_loop(solver_starts):
    """``batched_solve_and_marginalize`` without a mesh (one solve call and
    one fold call for the four windows) equals the per-window loop of
    ``solve_and_marginalize`` to the bit."""
    from dataclasses import fields

    from dsopp_tpu_torch.parallel.sharded import (batched_solve_and_marginalize,
                                                  solve_and_marginalize)

    windows, _, _, model, opts = solver_starts
    before = kernels.BA_SOLVE_LOOP.launches
    out, energy, count = batched_solve_and_marginalize(windows, model, opts)
    assert kernels.BA_SOLVE_LOOP.launches == before + 1
    for b in range(4):
        w, e, n = solve_and_marginalize(pba.window_at(windows, b), model, opts)
        got = pba.window_at(out, b)
        for f in fields(pba.Window):
            x, y = getattr(got, f.name), getattr(w, f.name)
            assert (x is None) == (y is None), f.name
            assert x is None or torch.equal(x, y), (b, f.name)
        assert torch.equal(energy[b], e) and torch.equal(count[b], n)


def test_batched_tick_with_keyframes_equals_solo_ticks(batch4):
    """One batched tick with every sequence forced to keyframe (the solver
    half once for the four) equals the four forced ``device_tick`` calls to
    the bit: the whole state, the ledger included, and the keyframe
    diagnostics."""
    from dsopp_tpu_torch.tracker import batched_loop as bl
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, TickDiag, device_tick

    _, _, trackers, images = batch4
    pipes = [PipelinedTracker(t) for t in trackers]
    states = [p.state for p in pipes]
    models, loop = pipes[0].models, pipes[0].cfg
    new, diag = bl.batched_device_tick(bl.stack_states(states), images, [6] * 4, [True] * 4,
                                       models, pipes[0].mask, loop)
    leaves = []
    bl._tree_map(lambda x: leaves.append(x) or x, new)
    for b in range(4):
        state, sdiag = device_tick(states[b], images[b], 6, True, models, loop)
        solo = []
        bl._tree_map(lambda x: solo.append(x) or x, state)
        assert all(torch.equal(x[b], y) for x, y in zip(leaves, solo)), b
        got = diag.sequence(b)
        for name in TickDiag._fields[TickDiag._fields.index("energy"):-1]:
            assert torch.equal(getattr(got, name), getattr(sdiag, name)), (b, name)


FRONT_KERNELS = ("select_candidates", "activation", "refine_idepth", "activation_scatter",
                 "depth_maps")


@pytest.fixture(scope="module")
def front4(batch4):
    """``batch4``'s four trackers at a forced keyframe: the keyframe
    backend's inputs (``testing/batched.py::front_inputs``)."""
    from dsopp_tpu_torch.testing import batched

    _, _, trackers, images = batch4
    return batched.front_inputs(trackers, images)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_batched_front_half_equals_solo_calls(front4, size):
    """The keyframe backend's phases 1 (the push, K12 and the banks, K13,
    K14) and 3 (K16) of S of the four sequences, one call each, equal to the
    bit to S solo calls: window, banks, slots, n_active, n_activated, depth
    maps and point sets; with no host read, a second call equal too."""
    from dsopp_tpu_torch.testing import batched

    seqs = SOLVER_SEQS[size]
    half = _no_host_reads(batched.front_half, front4, seqs)
    solos = [batched.front_half_solo(front4, b) for b in seqs]
    assert batched.front_half_equal(half, solos, seqs) == dict.fromkeys(batched.FRONT_PARTS,
                                                                        True)
    again = batched.front_half(front4, seqs)
    assert batched.front_half_equal(again, solos, seqs) == dict.fromkeys(batched.FRONT_PARTS,
                                                                         True)
    assert int(half["front"].n_activated.min()) > 0


@pytest.mark.parametrize("size", [1, 2, 4])
def test_batched_front_half_launches_equal_a_solo_call(front4, size):
    """Phases 1 and 3 at S sequences launch what one sequence's do: the
    wrappers' counts (each of K12, K13, K14's two entries and K16 once) and
    the host's launch calls outside torch operators."""
    from dsopp_tpu_torch.testing import batched

    seqs = SOLVER_SEQS[size]

    def launched(fn):
        fn()
        torch.cuda.synchronize()
        before = kernels.counts()
        with profiled([torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return ({k: v - before[k] for k, v in kernels.counts().items() if v != before[k]},
                launch_records(prof)["outside_ops"])

    got = launched(lambda: batched.front_half(front4, seqs))
    want = launched(lambda: batched.front_half_solo(front4, seqs[0]))
    assert got == want
    assert all(got[0][name] == 1 for name in FRONT_KERNELS), got


def test_batched_front_kernels_equal_solo_launches(front4):
    """K12, K13, K14 (the refinement and the pairing) and K16 over S = 4 of
    the stack in the order (1, 3, 0, 2), each one launch, every sequence
    equal to the bit to the solo wrapper's launch on the same inputs."""
    from dsopp_tpu_torch.testing import batched

    seqs = SOLVER_SEQS[4]
    half = batched.front_half(front4, seqs)
    windows, banks = half["front"].window, half["front"].immature
    maps, model, cfg = front4["out"].maps, front4["models"][0], front4["cfg"]
    md = front4["state"].min_distance
    one = lambda x, b: x[b]                                               # noqa: E731
    bank = lambda b: de.ImmaturePoints(*(x[b] for x in banks))             # noqa: E731
    act_s = act.activation_sequences(windows, model, banks, md, seqs)
    ref_s = act.refine_idepth_sequences(windows, model, banks, act_s[0], cfg.huber_sigma, seqs)
    cases = {
        "select_candidates": (
            lambda: extractor.select_candidates_sequences(maps[0], seqs, cfg.immature_per_frame,
                                                          front4["mask"]),
            lambda b, z: extractor.select_candidates_cuda(maps[0][b], cfg.immature_per_frame,
                                                          front4["mask"])),
        "activation": (lambda: act.activation_sequences(windows, model, banks, md, seqs),
                       lambda b, z: act._activation_cuda(pba.window_at(windows, b), model,
                                                         bank(b), md[b:b + 1])),
        "refine_idepth": (
            lambda: act.refine_idepth_sequences(windows, model, banks, act_s[0],
                                                cfg.huber_sigma, seqs),
            lambda b, z: act._refine_idepth_cuda(pba.window_at(windows, b), model, bank(b),
                                                 act_s[0][z], cfg.huber_sigma)),
        "activation_scatter": (
            lambda: act.activation_scatter_sequences(windows, banks, ref_s[1], act_s[1],
                                                     ref_s[0], ref_s[2], seqs),
            lambda b, z: act._activation_scatter_sequences_cuda(
                pba.window_at(windows, b), bank(b), ref_s[1][z], act_s[1][z], ref_s[0][z],
                ref_s[2][z], (0,), stacked=False)),
        "depth_maps": (
            lambda: dm.build_frontend_state_sequences(windows, model, maps, seqs, cfg.height,
                                                      cfg.width, cfg.num_levels,
                                                      cfg.frontend_points),
            lambda b, z: dm.build_frontend_state_cuda(pba.window_at(windows, b), model,
                                                      tuple(one(m, b) for m in maps),
                                                      cfg.height, cfg.width, cfg.num_levels,
                                                      cfg.frontend_points)),
    }
    for name, (fn, solo) in cases.items():
        before = kernels.counts()[name]
        out = _no_host_reads(fn)
        assert kernels.counts()[name] == before + 1, name
        got = batched.flat(out)
        for z, b in enumerate(seqs):
            want = batched.flat(solo(b, z))
            assert len(want) == len(got), name
            for x, y in zip(got, want):
                assert torch.equal(x[z], y), (name, b)


def test_batched_front_half_at_c3(batch4):
    """Phases 1 and 3 of two and four of four trackers with the filter-bank
    embedder (C = 3: the keyframes' channels in one convolution, their maps
    in one K1 launch, K14's pairing sampling the stacked channel bank) equal
    to the bit to the solo calls, K1 once a call."""
    from dataclasses import replace

    from dsopp_tpu_torch.testing import batched

    seq, cfg, _, images = batch4
    cfg3 = replace(cfg, embedder="filter_bank")
    trackers = [batched.offset_bootstrap(seq, cfg3, k) for k in range(4)]
    inputs = batched.front_inputs(trackers, images)
    assert inputs["state"].window.channel_maps.shape[2] == 9
    for seqs in ((3, 0), (1, 3, 0, 2)):
        before = kernels.PYRAMID.launches
        half = _no_host_reads(batched.front_half, inputs, seqs)
        assert kernels.PYRAMID.launches == before + 1
        solos = [batched.front_half_solo(inputs, b) for b in seqs]
        assert batched.front_half_equal(half, solos, seqs) == dict.fromkeys(
            batched.FRONT_PARTS, True), seqs


def test_batched_tick_with_some_keyframes_equals_solo_ticks(batch4):
    """One batched tick with the forced flags (True, False, True, True), the
    strategy's factor 0 and sequence 1's rmse memory far above its rmse (no
    keyframe decided otherwise): the keyframe
    backend once for three sequences, written into their rows in place;
    every sequence equal to the bit to its solo tick, the stacked maps
    keeping their storage."""
    from dsopp_tpu_torch.tracker import batched_loop as bl
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, device_tick

    _, _, trackers, images = batch4
    pipes = [PipelinedTracker(t) for t in trackers]
    states = [p.state for p in pipes]
    states[1] = states[1]._replace(kf_rmse=torch.full_like(states[1].kf_rmse, 1e9))
    models, loop = pipes[0].models, pipes[0].cfg._replace(keyframe_factor=0.0)
    forced = (True, False, True, True)
    stack = bl.stack_states(states)
    ptr = stack.window.maps.data_ptr()
    new, diag = bl.batched_device_tick(stack, images, [6] * 4, list(forced), models,
                                       pipes[0].mask, loop)
    assert diag.is_keyframe == forced
    assert new.window.maps.data_ptr() == ptr
    leaves = []
    bl._tree_map(lambda x: leaves.append(x) or x, new)
    for b in range(4):
        state, _ = device_tick(states[b], images[b], 6, forced[b], models, loop)
        solo = []
        bl._tree_map(lambda x: solo.append(x) or x, state)
        assert all(torch.equal(x[b], y) for x, y in zip(leaves, solo)), b
