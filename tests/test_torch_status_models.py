"""Host models of kernel K11's design (``dsopp_tpu_torch/testing/status_models.py``)
on the CPU, ~5 s on one worker:

* the multi-block radix select of the outlier quantile — digits of 11, 11
  and 10 bits (and of 8 bits, and of 16), both ranks in the same sweeps, the
  blocks' histograms added in a random order — under hypothesis on energies
  with ties, zeros and subnormals, and with m = 0, 1, 2 ok groups: the two
  order statistics equal to the sorted ok energies' to the bit, the
  quantile within one f32 ulp of ``torch.nanquantile``'s (torch's CPU
  ``lerp`` fuses its product and sum into one rounding, the kernel rounds
  twice, as torch's formula reads); on the status problem's energies the
  threshold equal to ``_point_status_from_ev_plain``'s to the bit;
* the status grid (a block per anchor and 32 landmarks, the inliers'
  baselines taken with fmaxf from 0 in target order) equal to
  ``_point_status_from_ev_plain`` on a small window: statuses, inlier
  counts, outlier flags and optimization counts to the bit, baselines within
  1e-6 relative (torch's ``vector_norm`` against the kernel's sqrt of the
  squares), with negative inverse depths among the landmarks.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.testing import status_models as sm

QUANTILE = pba.OUTLIER_QUANTILE
DIGITS = ((11, 11, 10), (8, 8, 8, 8), (16, 16))


def _nanquantile(energy, ok):
    flat = torch.where(torch.as_tensor(ok), torch.as_tensor(energy),
                       torch.tensor(float("nan"))).reshape(-1)
    q = torch.nanquantile(flat, QUANTILE)
    return np.float32(0.0) if torch.isnan(q) else np.float32(q.item())


def _check_quantile(energy, ok, **select):
    """The model's order statistics against the sorted ok energies, its
    quantile against ``torch.nanquantile``'s."""
    m = int(ok.sum())
    at = np.float32(QUANTILE) * np.float32(m - 1)
    ranks = (int(np.floor(at)), int(np.ceil(at)))
    if m:
        chosen = sm.radix_select(energy.view(np.uint32), ok, ranks, **select)
        want = np.sort(energy[ok])[list(ranks)].view(np.uint32)
        assert list(chosen) == list(want), (select, chosen, want)
    got = sm.outlier_threshold(energy, ok, QUANTILE, 0.0, **select)
    want = _nanquantile(energy, ok)
    assert abs(got - want) <= np.spacing(max(got, want)), (select, got, want)


_TIES = st.sampled_from([np.float32(v) for v in (0.0, 1e-40, 3.5, 3.5000002, 17.25, 1e5)])
_SUBNORMAL = st.integers(1, 0x007FFFFF).map(lambda b: np.uint32(b).view(np.float32))
_NORMAL = st.floats(2.0 ** -100, 2.0 ** 100, allow_nan=False, allow_infinity=False, width=32)
ENERGY = st.one_of(_TIES, _SUBNORMAL, _NORMAL, st.just(np.float32(0.0)))


@settings(max_examples=120, deadline=None)
@given(values=st.lists(st.tuples(ENERGY, st.booleans()), min_size=1, max_size=600),
       block=st.sampled_from([7, 64, 1024]), seed=st.integers(0, 2 ** 16))
def test_radix_select_is_nanquantile(values, block, seed):
    energy = np.array([v for v, _ in values], np.float32)
    ok = np.array([o for _, o in values], bool)
    blocks = -(-len(energy) // block)
    order = np.random.default_rng(seed).permutation(blocks)
    for widths in DIGITS:
        _check_quantile(energy, ok, widths=widths, block_groups=block, order=order)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_radix_select_few_ok_groups(m):
    rng = np.random.default_rng(m)
    energy = rng.random(3000).astype(np.float32) * 100
    ok = np.zeros(3000, bool)
    ok[rng.choice(3000, m, replace=False)] = True
    _check_quantile(energy, ok)


def _problem(seed, k=5, n=40):
    """A CPU window of ``k`` frames and ``n`` landmarks, and an evaluation."""
    rng = np.random.default_rng(seed)
    w = pba.empty_window(k, n, (3, 8, 8), device="cpu")
    q = rng.normal(size=(k, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    idepth = rng.normal(0.5, 0.4, (k, n)).astype(np.float32)     # some negative
    w = w.replace(t_lin_q=torch.as_tensor(q), t_lin_t=torch.as_tensor(rng.normal(size=(k, 3)),
                                                                       dtype=torch.float32),
                  eps=torch.as_tensor(rng.normal(0, 1e-2, (k, 8)), dtype=torch.float32),
                  lm_idepth=torch.as_tensor(idepth),
                  lm_baseline=torch.as_tensor(rng.random((k, n)) * 0.05, dtype=torch.float32),
                  lm_outlier=torch.as_tensor(rng.random((k, n)) < 0.1),
                  lm_opt_count=torch.as_tensor(rng.integers(0, 5, (k, n)), dtype=torch.int32))
    energy = (rng.random((k, k, n)) ** 3 * 500).astype(np.float32)
    energy[rng.random((k, k, n)) < 0.1] = 0.0
    ok = rng.random((k, k, n)) < 0.7
    cand = rng.integers(0, 4, (k, k, n)).astype(np.int32)
    zeros = torch.zeros((k, k, n, 1, 8))
    ev = pba.Evaluation(zeros, torch.as_tensor(energy), torch.zeros((k, k, n)),
                        torch.as_tensor(cand), zeros, zeros, torch.as_tensor(ok))
    lm_mask = torch.as_tensor(rng.random((k, n)) < 0.8)
    return w, ev, lm_mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_status_grid_matches_plain(seed):
    w, ev, lm_mask = _problem(seed)
    opts = pba.PBAOptions(min_valid_reprojections=2)
    ps = pba._point_status_from_ev_plain(w, ev, lm_mask, opts)
    e, ok = ev.energy_patch.numpy(), ev.ok.numpy()
    thresh = sm.outlier_threshold(e, ok, QUANTILE, opts.huber_sigma, block_groups=64)
    assert thresh.view(np.uint32) == np.float32(ps.threshold.item()).view(np.uint32)
    pos = (w.t_lin() @ SE3.exp(w.eps[:, :6])).t.numpy()
    status, baseline, count, outlier, opt = sm.point_status(
        e, ok, ev.status_candidate.numpy(), thresh, pos, w.lm_idepth.numpy(), lm_mask.numpy(),
        w.lm_baseline.numpy(), w.lm_outlier.numpy(), w.lm_opt_count.numpy(),
        opts.min_valid_reprojections)
    assert int((status == pba.RES_OUTLIER).sum()) > 0
    np.testing.assert_array_equal(status, ps.res_status.numpy())
    np.testing.assert_array_equal(count, ps.lm_inliers.numpy())
    np.testing.assert_array_equal(outlier, ps.lm_outlier.numpy())
    np.testing.assert_array_equal(opt, ps.lm_opt_count.numpy())
    np.testing.assert_allclose(baseline, ps.lm_baseline.numpy(), rtol=1e-6, atol=0)
