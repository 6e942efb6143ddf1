"""The reference window BA: the problem it reads from a map, and its
solve on a window with a known answer, in float64 and in TF32."""

import numpy as np
import torch

from benchmark.reference import ba

CPU = torch.device("cpu")
K = np.array([[700.0, 0, 620], [0, 700.0, 188], [0, 0, 1]])
SPEC = dict(window=4, max_window_cameras=12, max_window_points=5,
            gauge_fixed_cameras=2, point_freeze_margin=1, cauchy=1.0)


def tiny_map():
    """6 keyframes (the window is the last 4), 8 points, 3 keypoints a
    keyframe."""
    Kmax, N, P, O = 6, 3, 8, 4
    kp2mp = np.full((Kmax, N), -1, np.int32)
    obs_kf = np.full((P, O), -1, np.int32)
    obs_kp = np.full((P, O), -1, np.int32)
    first_kf = np.zeros(P, np.int32)
    table = {(2, 0): 7, (2, 1): 1, (3, 0): 1, (3, 1): 2, (3, 2): 6,
             (4, 0): 2, (4, 1): 3, (5, 0): 3, (5, 1): 4, (5, 2): 0}
    for (kf, kp), p in table.items():
        kp2mp[kf, kp] = p
        j = int((obs_kf[p] >= 0).sum())
        obs_kf[p, j], obs_kp[p, j] = kf, kp
    obs_kf[4, 0] = -1          # the table dropped (5, 1): not observed there
    first_kf[[1, 2, 3, 4, 6, 7]] = [1, 3, 4, 5, 3, 2]     # point 0: 0
    valid = np.ones(P, bool)
    bad = np.zeros(P, bool)
    bad[6] = True              # culled: not a window point
    return dict(num_kf=np.int32(6), kf_kp2mp=kp2mp,
                kf_kp_valid=np.ones((Kmax, N), bool),
                kf_kpts=np.arange(Kmax * N * 2, dtype=np.float32).reshape(
                    Kmax, N, 2),
                kf_R=np.tile(np.eye(3), (Kmax, 1, 1)),
                kf_t=np.zeros((Kmax, 3)), pts_xyz=np.ones((P, 3)),
                pts_valid=valid, pts_bad=bad, pts_first_kf=first_kf,
                pts_obs_kf=obs_kf, pts_obs_kp=obs_kp)


def test_the_window_problem_read_from_a_map():
    prob = ba.window_problem(tiny_map(), SPEC, K, CPU)
    assert prob.first == 2
    # named by window keyframes, live, the lowest 5 ids (7 is cut)
    assert list(prob.pt_ids) == [0, 1, 2, 3, 4]
    obs = sorted(zip((prob.cam + prob.first).tolist(),
                     prob.pt_ids[prob.pt.numpy()].tolist()))
    # (2, 0) names the cut point 7, (3, 2) the culled 6, and the table of
    # point 4 does not list (5, 1)
    assert obs == [(2, 1), (3, 1), (3, 2), (4, 2), (4, 3), (5, 0), (5, 3)]
    assert prob.cam_free.tolist() == [False, False, True, True]
    # point 0 was made before first - point_freeze_margin; point 4 has no
    # observation left
    assert prob.pt_free.tolist() == [False, True, True, True, False]


def synthetic_window(seed=0, C=5, P=300):
    g = np.random.default_rng(seed)
    R = np.tile(np.eye(3), (C, 1, 1))
    centers = np.stack([np.zeros(C), np.zeros(C), np.arange(C, dtype=float)],
                       1)
    t = -centers
    X = np.stack([g.uniform(-20, 20, P), g.uniform(-4, 4, P),
                  g.uniform(8, 60, P)], 1)
    cam = np.repeat(np.arange(C), P)
    pt = np.tile(np.arange(P), C)
    pc = X[pt] - centers[cam]
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + K[:2, 2]
    uv = uv + g.normal(scale=0.3, size=uv.shape)
    prob = ba.Problem(
        first=0, cam=torch.as_tensor(cam), pt=torch.as_tensor(pt),
        uv=torch.as_tensor(uv), cam_free=torch.arange(C) >= 2,
        pt_free=torch.ones(P, dtype=torch.bool), pt_ids=np.arange(P),
        K=(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), cauchy=1.0)
    truth = tuple(torch.as_tensor(a) for a in (R, t, X))
    start = (truth[0], truth[1] + torch.as_tensor(
        np.r_[np.zeros((2, 3)), g.normal(scale=0.05, size=(C - 2, 3))]),
        truth[2] * torch.as_tensor(1 + g.normal(scale=0.02, size=(P, 1))))
    return prob, truth, start


def test_the_solve_reaches_the_minimum_and_tf32_falls_short():
    prob, truth, start = synthetic_window()
    c_truth = ba.cost(prob, *truth)
    c_start = ba.cost(prob, *start)
    *best, n = ba.solve(prob, *start)
    c_best = ba.cost(prob, *best)
    assert c_start > 5 * c_truth
    # noise of 0.3 px: the minimum lies a little below the truth's cost
    assert 0.5 * c_truth < c_best <= c_truth and n < 100
    # the held cameras do not move
    torch.testing.assert_close(best[0][:2], start[0][:2], rtol=0, atol=0)
    torch.testing.assert_close(best[1][:2], start[1][:2], rtol=0, atol=0)
    # from the minimum it stays there
    again = ba.solve(prob, *best)
    assert ba.cost(prob, *again[:3]) <= c_best * (1 + 1e-9)
    low = ba.solve(prob, *start, tf32_on=True)[:3]
    assert ba.cost(prob, *low) > 1.05 * c_best


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                      1.0 + 2 ** -12])
    got = ba.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                            -3.0 - 2 ** -9, 1.0]
