"""GICP's LM lambda search (``ops.cuda.lm_kernel``): the plain version
against the sequential masked loop that ran before kernel D, kept here as
the oracle, and kernel D against the plain version. This file imports no
JAX, so that the tests marked ``cuda`` also run on a machine with a card
and no JAX:

    python -m pytest -m cuda tests/test_torch_lm_search.py

Without a card those tests skip; the plain-version tests run everywhere."""

import numpy as np
import pytest
import torch

from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.ops import gicp as tg
from noetic_slam_tpu_torch.ops.cuda import lm_kernel as lk

torch.set_num_threads(1)

CFG = GicpConfig()
K = CFG.lm_max_iterations


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel test)")
    return torch.device("cuda")


def inner_lm_oracle(cfg, src_xyz, corr, H, b, y0, x0, lm_lambda):
    """The LM lambda search as the port ran it before kernel D:
    ``lm_max_iterations`` masked iterations, each a solve, an exponential,
    the error over every pair and the carry's selects. Returns (accepted,
    x_new, lambda_new, delta_T, y_new, k): k the iteration that ended the
    search, ``lm_max_iterations`` when none did."""
    dev, dtype = src_xyz.device, src_xyz.dtype
    lam = torch.where(lm_lambda < 0.0,
                      cfg.init_lambda_factor * torch.max(torch.abs(
                          torch.diagonal(H))), lm_lambda)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    accepted = done.clone()
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    x, y = x0, y0
    dT = torch.eye(4, dtype=dtype, device=dev)
    k_end = torch.full((), cfg.lm_max_iterations, dtype=torch.int32)
    for k in range(cfg.lm_max_iterations):
        d = torch.linalg.solve_ex(H + lam * eye6, -b)[0]
        delta = lk.delta_to_T(d)
        xi = delta @ x
        yi = tg.compute_error(src_xyz, corr, xi)
        rho = (y0 - yi) / torch.dot(d, lam * d - b)
        reject = rho < 0
        conv_on_reject = reject & lk.is_converged(
            delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
        lam_new = torch.where(
            reject, nu * lam,
            lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0))
        nu_new = torch.where(reject, 2.0 * nu, 2.0)
        step_done = ~reject | conv_on_reject
        # a finished search keeps its carry
        keep = done
        lam = torch.where(keep, lam, lam_new)
        nu = torch.where(keep, nu, nu_new)
        x = torch.where(keep | reject, x, xi)
        y = torch.where(keep | reject, y, yi)
        dT = torch.where(keep, dT, delta)
        accepted = torch.where(keep, accepted, step_done)
        k_end = torch.where(~keep & step_done, k, k_end)
        done = done | step_done
    return accepted, x, lam, dT, y, k_end


def _planes(rng, n):
    """Points on three orthogonal planes (a well-constrained target)."""
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    pts[np.arange(n), axis] = -4.0
    return pts


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _problem(n_src, seed=0, offset=(0.0, 0.0, 0.0), device="cpu"):
    """One outer iteration's search inputs on a clouds-on-planes problem
    (the GICP tests' scene: a source cut from the target, noised, turned
    0.03 rad and moved 9 cm, the whole ``offset`` from the origin),
    linearised at the identity: (src_xyz, corr, H, b, y0, x0)."""
    rng = np.random.default_rng(seed)
    n_tgt = 4 * n_src
    tgt = _planes(rng, n_tgt) + np.asarray(offset, np.float32)
    src = tgt[rng.choice(n_tgt, n_src, replace=False)].copy()
    src += rng.normal(0, 0.005, src.shape).astype(np.float32)
    src = (src @ _rot_z(0.03).T + np.array([0.08, -0.05, 0.02])
           ).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    valid_s = torch.ones(n_src, dtype=torch.bool, device=device)
    valid_t = torch.ones(n_tgt, dtype=torch.bool, device=device)
    src_cov = tg.radius_covariances(t(src), valid_s, 0.5)[0]
    tgt_cov = tg.radius_covariances(t(tgt), valid_t, 0.5)[0]
    x0 = torch.eye(4, device=device)
    corr = tg.update_correspondences(
        t(src), valid_s, src_cov, t(tgt), tgt_cov, x0,
        torch.tensor(0.5, device=device))
    H, b, y0 = tg.linearize(t(src), corr, x0)
    return t(src), corr, H, b, y0, x0


def _kind(res, x0):
    accepted, x, _, _, _, k = res
    if not bool(accepted):
        return "none"
    moved = not torch.equal(x, x0)
    return f"accept{int(k)}" if moved else f"conv_on_reject{int(k)}"


def _scaled(kind, sign, src, corr, H, b, y0, x0, lam_in):
    """b scaled by sign * 2^(e/8), the first e = 0..640 whose oracle search
    ends as ``kind``: the scaled gradient overshoots (sign +1) until lambda
    has grown enough, or points uphill (sign -1) until the step falls below
    the convergence thresholds."""
    for e in range(641):
        bs = b * (sign * 2.0 ** (e / 8))
        res = inner_lm_oracle(CFG, src, corr, H, bs, y0, x0, lam_in)
        if _kind(res, x0) == kind:
            return bs, res
    raise AssertionError(f"no scale of b makes the search end as {kind}")


# (what ends the search, b's sign, lambda in, source points). From the
# first search's lambda_0 (1e-9 max|diag H|) lambda needs about seven
# doublings to matter, so 1 to 6 rejects take a larger incoming lambda.
CASES = [("accept0", 1, "init", 512), ("accept9", 1, "init", 512),
         ("none", -1, "init", 512), ("conv_on_reject8", -1, "init", 512),
         ("accept0", 1, "given", 512), ("accept1", 1, "given", 512),
         ("accept3", 1, "given", 512), ("accept9", 1, "given", 512),
         ("none", -1, "given", 512), ("conv_on_reject3", -1, "given", 512),
         ("accept0", 1, "init", 2500), ("accept1", 1, "given", 2500),
         ("accept3", 1, "given", 2500)]


def _lam_in(mode, H):
    if mode == "init":
        return torch.full((), -1.0)
    # a lambda a previous search could hand on: a tenth of H's diagonal
    return 0.1 * torch.max(torch.abs(torch.diagonal(H)))


@pytest.mark.parametrize("kind,sign,lam_mode,n_src", CASES)
def test_plain_matches_the_masked_loop(kind, sign, lam_mode, n_src):
    """Every candidate solved and scored at once, then the carry over k:
    lambda, accepted, stop and the chosen k exactly the masked loop's; x, y
    and dT to f32 rounding."""
    src, corr, H, b, y0, x0 = _problem(n_src)
    lam_in = _lam_in(lam_mode, H)
    if kind != "accept0":
        b, want = _scaled(kind, sign, src, corr, H, b, y0, x0, lam_in)
    else:
        want = inner_lm_oracle(CFG, src, corr, H, b, y0, x0, lam_in)
    assert _kind(want, x0) == kind
    got = lk.lm_search_plain(CFG, src, corr.tgt_rows, corr.maha, H, b, y0,
                             x0, lam_in)
    w_acc, w_x, w_lam, w_dT, w_y, w_k = want
    assert torch.equal(got.lam, w_lam)
    assert bool(got.accepted) == bool(w_acc)
    assert int(got.k) == int(w_k)
    w_conv = w_acc & lk.is_converged(w_dT, CFG.rotation_epsilon,
                                     CFG.transformation_epsilon)
    assert bool(got.converged) == bool(w_conv)
    assert bool(got.stop) == bool(w_conv | ~w_acc)
    for a, w in ((got.x, w_x), (got.y, w_y), (got.dT, w_dT)):
        torch.testing.assert_close(a, w, rtol=2e-7, atol=0)
    # the lambda schedule: candidate k at lambda_0 * 2^(k(k+1)/2), exact
    k = int(w_k)
    if kind.startswith(("none", "conv")):
        lam0 = torch.where(lam_in < 0, CFG.init_lambda_factor * torch.max(
            torch.abs(torch.diagonal(H))), lam_in)
        steps = K if kind == "none" else k + 1
        assert float(got.lam) == float(lam0) * 2.0 ** (
            steps * (steps + 1) // 2)


@pytest.mark.parametrize("budget", [0, 1, 16])
def test_plain_matches_the_masked_loop_at_other_budgets(budget):
    """No candidate (x0, y0 and lambda_0 stay, dT the identity), one, and
    the kernel's most, with one reject forced at the larger budgets."""
    cfg = GicpConfig(lm_max_iterations=budget)
    src, corr, H, b, y0, x0 = _problem(512)
    lam_in = _lam_in("given", H)
    bs = b * 2.0 if budget else b
    want = inner_lm_oracle(cfg, src, corr, H, bs, y0, x0, lam_in)
    got = lk.lm_search_plain(cfg, src, corr.tgt_rows, corr.maha, H, bs, y0,
                             x0, lam_in)
    w_acc, w_x, w_lam, w_dT, w_y, w_k = want
    assert torch.equal(got.lam, w_lam) and int(got.k) == int(w_k)
    assert bool(got.accepted) == bool(w_acc)
    for a, w in ((got.x, w_x), (got.y, w_y), (got.dT, w_dT)):
        torch.testing.assert_close(a, w, rtol=2e-7, atol=0)
    if not budget:
        assert int(got.k) == 0 and not bool(got.accepted)
        assert bool(got.stop) and torch.equal(got.dT, torch.eye(4))


@pytest.mark.parametrize("n", [1, 700, 1024, 1025, 3000])
def test_error_sums_order_and_batch(n):
    """``error_sums`` over a batch of transforms equals it one transform
    at a time bitwise, equals its own definition (terms rounded in D's
    order, summed over j, lanes, warps, blocks) computed in numpy, and the
    float64 sum to the rounding of e's cancellation."""
    rng = np.random.default_rng(n)
    src = rng.normal(0, 5, (n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.1, (n, 3))).astype(np.float32)
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    ang = rng.normal(0, 0.05, (4, 3))
    T = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for i in range(4):
        T[i, :3, :3] = _rot_z(ang[i, 2])
        T[i, :3, 3] = ang[i] * 3
    got = lk.error_sums(*(torch.from_numpy(a) for a in (src, tgt, M, T)))
    for i in range(4):
        one = tg.compute_error(
            torch.from_numpy(src),
            tg.Correspondences(None, torch.from_numpy(tgt),
                               torch.from_numpy(M), None, None),
            torch.from_numpy(T[i]))
        assert torch.equal(got[i], one)
        # numpy, one f32 operation at a time, the kernel's order
        f = np.float32
        R, t = T[i, :3, :3], T[i, :3, 3]
        e = [tgt[:, r] - (((R[r, 0] * src[:, 0] + R[r, 1] * src[:, 1])
                           + R[r, 2] * src[:, 2]) + t[r]) for r in range(3)]
        Me = [(M[:, r, 0] * e[0] + M[:, r, 1] * e[1]) + M[:, r, 2] * e[2]
              for r in range(3)]
        q = (e[0] * Me[0] + e[1] * Me[1]) + e[2] * Me[2]
        blocks = max(1, -(-n // 1024))
        q = np.concatenate([q, np.zeros(blocks * 1024 - n, f)])
        q = q.reshape(blocks, 4, 8, 32)
        acc = ((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]
        for h in (16, 8, 4, 2, 1):
            acc = acc[..., :h] + acc[..., h:2 * h]
        acc = acc[..., 0]
        for h in (4, 2, 1):
            acc = acc[..., :h] + acc[..., h:2 * h]
        s = acc[0, 0]
        for g in range(1, blocks):
            s = f(s + acc[g, 0])
        assert got[i].item() == s
        e64 = tgt.astype(np.float64) - (src.astype(np.float64) @ R.T + t)
        exact = np.einsum("ni,nij,nj->", e64, M.astype(np.float64), e64)
        # e = t - (R p + t) cancels metres down to centimetres: ~1e-5 each
        assert abs(got[i].item() - exact) <= 1e-4 * abs(exact)


def test_gicp_align_takes_the_plain_search_on_the_cpu(monkeypatch):
    """On the CPU every outer iteration runs one plain search, and its
    ``stop`` is the flag the host reads."""
    src = _problem(512)[0]
    calls = []
    plain = lk.lm_search_plain

    def counted(*a):
        calls.append(plain(*a))
        return calls[-1]

    monkeypatch.setattr(lk, "lm_search_plain", counted)
    rng = np.random.default_rng(0)
    tgt = _planes(rng, 2048)
    t = torch.from_numpy(tgt)
    cov = tg.radius_covariances(t, torch.ones(2048, dtype=torch.bool),
                                0.5)[0]
    scov = tg.radius_covariances(src, torch.ones(512, dtype=torch.bool),
                                 0.5)[0]
    syncs = tg.HostSyncs()
    res = tg.gicp_align(src, torch.ones(512, dtype=torch.bool), scov, t, cov,
                        CFG, syncs=syncs)
    assert len(calls) == int(res.iterations) == syncs.n > 0
    assert bool(calls[-1].stop) and not any(bool(c.stop) for c in calls[:-1])
    assert bool(res.converged) == bool(calls[-1].converged)
    assert torch.equal(res.T, calls[-1].x)
    assert lk.lm_search_fused.launches == 0


def test_fused_refuses_cpu_tensors_and_too_many_candidates():
    src, corr, H, b, y0, x0 = _problem(64)
    args = (src, corr.tgt_rows, corr.maha, H, b, y0, x0,
            torch.full((), -1.0))
    with pytest.raises(ValueError, match="CUDA"):
        lk.lm_search_fused(CFG, *args)
    with pytest.raises(ValueError, match="lm_max_iterations"):
        lk.lm_search_fused(GicpConfig(lm_max_iterations=lk.KMAX + 1), *args)


# --- kernel D on the card ---------------------------------------------------

def _card_case(dev, n_src, kind="accept0", sign=1, lam_mode="init",
               offset=(0.0, 0.0, 0.0)):
    """A case built on the CPU (the oracle's scale search), moved to
    ``dev``."""
    src, corr, H, b, y0, x0 = _problem(n_src, offset=offset)
    lam_in = _lam_in(lam_mode, H)
    if kind != "accept0":
        b, _ = _scaled(kind, sign, src, corr, H, b, y0, x0, lam_in)
    return tuple(x.to(dev) for x in (src, corr.tgt_rows, corr.maha, H, b,
                                     y0, x0, lam_in))


def _check_kernel_case(args):
    """Kernel D against the plain version on one search's operands: the
    same chosen k, accepted and stop, x within 1e-5 (of its scale), y the
    plain error at the kernel's own x bitwise; lambda exact where the
    search ended on a reject (a product of the schedule), within 1e-6
    after an accept, where lambda_k is scaled by a factor of rho and rho
    carries each side's own 6x6 solve (seen: one ulp apart)."""
    got = lk.lm_search_fused(CFG, *args)
    want = lk.lm_search_plain(CFG, *args)
    assert int(got.k) == int(want.k)
    assert bool(got.accepted) == bool(want.accepted)
    assert bool(got.stop) == bool(want.stop)
    assert bool(got.converged) == bool(want.converged)
    scale = max(1.0, float(torch.abs(want.x).max()))
    assert float(torch.abs(got.x - want.x).max()) <= 1e-5 * scale
    moved = not torch.equal(got.x, args[6])
    if moved:
        torch.testing.assert_close(got.lam, want.lam, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got.lam, want.lam)
    at_x = lk.error_sums(args[0], args[1], args[2], got.x)
    assert torch.equal(got.y, at_x if moved else args[5])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sign,lam_mode,n_src", CASES)
def test_kernel_matches_plain(cuda_device, kind, sign, lam_mode, n_src):
    _check_kernel_case(_card_case(cuda_device, n_src, kind, sign, lam_mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n_src", [8192, 4096])
def test_kernel_matches_plain_at_the_main_shapes(cuda_device, n_src):
    """The main path's 8,192 kept points and a ``verify_loop``-sized
    cloud 30 m out; two launches bitwise equal."""
    args = _card_case(cuda_device, n_src, offset=(30.0, -20.0, 1.0))
    a = _check_kernel_case(args)
    b = lk.lm_search_fused(CFG, *args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 1, 16])
def test_kernel_matches_plain_at_other_budgets(cuda_device, budget):
    cfg = GicpConfig(lm_max_iterations=budget)
    args = list(_card_case(cuda_device, 512, lam_mode="given"))
    if budget:
        args[4] = args[4] * 2.0
    got = lk.lm_search_fused(cfg, *args)
    want = lk.lm_search_plain(cfg, *args)
    for name in ("k", "accepted", "stop", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(torch.abs(got.x - want.x).max()) <= 1e-5
    if torch.equal(got.x, args[6]):
        assert torch.equal(got.lam, want.lam)
    else:
        torch.testing.assert_close(got.lam, want.lam, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_kernel_grows_its_workspace(cuda_device):
    """20,480 pairs (a 4,096-pair problem five times over): 20 blocks,
    more than the workspace's first 8."""
    src, rows, maha, _, _, y0, x0, lam_in = _card_case(cuda_device, 4096)
    src, rows, maha = (x.repeat((5,) + (1,) * (x.dim() - 1))
                       for x in (src, rows, maha))
    corr = tg.Correspondences(None, rows, maha, None, None)
    H, b, y0 = tg.linearize(src, corr, x0)
    _check_kernel_case((src, rows, maha, H, b, y0, x0, lam_in))


@pytest.mark.cuda
def test_kernel_shape_and_tally(cuda_device):
    assert lk.kernel_shape() == {"kmax": lk.KMAX,
                                 "block_pairs": lk.BLOCK_PAIRS}
    args = _card_case(cuda_device, 512, "accept3", 1, "given")
    lk.reset_tally(cuda_device)
    n0 = lk.lm_search_fused.launches
    for _ in range(3):
        lk.lm_search(CFG, *args)
    assert lk.lm_search_fused.launches == n0 + 3
    counts = lk.tally(cuda_device)
    assert counts[3] == 3 and sum(counts) == 3
